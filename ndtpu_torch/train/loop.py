"""Train and eval steps of NDT-Net segmentation, NDT-Net classification,
NDT-Net++ segmentation and the PointNet baseline (port of
``ndtpu/train/loop.py``).

A step is the JAX step's sequence in eager PyTorch: the NDT preprocessing
without a gradient (on the card one segment-moments kernel launch per
resolution, tagged with the ground truth's class slots where there is a
per-point ground truth), the train-mode forward to logits, softmax
cross-entropy from logits (over the kept NDs for segmentation), the
backward, and one Adam update at the schedule's rate (the PointNet step
has no preprocessing: the model takes the points). Metrics come back as
device scalars: nothing in the step after the preprocessing waits for the
card.
"""
from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: int = 20, decay_rate: float = 0.5):
    """Staircase decay, ``optax.exponential_decay(staircase=True)``: count
    -> base_lr * decay_rate ** (count // max(1, decay_epochs *
    steps_per_epoch)), in float32 as optax evaluates it. The count is the
    optimizer's step before the update."""
    transition = max(1, decay_epochs * steps_per_epoch)

    def schedule(count: int) -> float:
        p = np.float32(count // transition)
        return float(np.float32(base_lr) * np.power(np.float32(decay_rate), p))

    return schedule


def cross_entropy_loss(logits, onehot, mask=None):
    """Mean softmax cross-entropy over the (optionally masked) rows; the
    masked mean divides by max(sum(mask), 1)."""
    ce = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    if mask is None:
        return ce.mean()
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, ce, 0.0).sum() / denom


def accuracy(logits, onehot, mask=None):
    """Fraction of rows whose argmax (the first maximum) matches the
    ground truth's."""
    hit = (logits.argmax(-1) == onehot.argmax(-1)).to(torch.float32)
    if mask is None:
        return hit.mean()
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, hit, 0.0).sum() / denom


def _update(state, loss):
    """Backward of ``loss`` and one optimizer update."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.apply_gradients()


def _make_prep(n_desired_nds, n_classes, search):
    """The step's preprocessing, without a gradient: (points [B, N, 3],
    ground truth or None, optional [B] voxel sizes) -> (points, covs,
    one-hot, mask, NDTResult)."""

    def prep(points, gt, voxel_sizes=None):
        with torch.no_grad():
            return ndt_preprocessing_with_state(
                n_desired_nds, points, gt, n_classes, search=search,
                fixed_voxel_sizes=voxel_sizes,
            )

    return prep


def make_ndt_seg_step(n_desired_nds: int, n_classes: int,
                      search: str = "fast"):
    """(step, eval_step) for NDTNetSegmentation.

    ``step(state, points, gt, *voxel_sizes) -> (state, metrics)`` and
    ``eval_step(state, points, gt, *voxel_sizes) -> metrics``. points [B,
    N, 3]; gt the one-hot [B, N, C+1] or int class tags [B, N]; an optional
    trailing [B] of voxel sizes skips the search (the streaming regime).
    ``state`` is a ``TrainState`` (ndtpu_torch.train.state), updated in
    place. metrics: {"loss", "accuracy"} as device scalars.
    """
    prep = _make_prep(n_desired_nds, n_classes, search)

    def step(state, points, gt, *voxel_sizes):
        pcl, covs, onehot, mask, _ = prep(points, gt, *voxel_sizes)
        model = state.model.train()
        logits = model(pcl, covs, return_logits=True)
        loss = cross_entropy_loss(logits, onehot, mask)
        _update(state, loss)
        with torch.no_grad():
            acc = accuracy(logits, onehot, mask)
        return state, {"loss": loss.detach(), "accuracy": acc}

    def eval_step(state, points, gt, *voxel_sizes):
        pcl, covs, onehot, mask, _ = prep(points, gt, *voxel_sizes)
        model = state.model.eval()
        with torch.no_grad():
            logits = model(pcl, covs, return_logits=True)
            return {"loss": cross_entropy_loss(logits, onehot, mask),
                    "accuracy": accuracy(logits, onehot, mask)}

    return step, eval_step


def make_classification_step(n_desired_nds: int, n_classes: int,
                             search: str = "fast"):
    """(step, eval_step) for NDTNetClassification (loop.py:346-386):
    ``step(state, points [B, N, 3], label_onehot [B, C]) -> (state,
    metrics)``, ``eval_step(state, points, label_onehot) -> metrics``. The
    preprocessing is untagged; the loss is the mean over the B clouds."""
    prep = _make_prep(n_desired_nds, n_classes, search)

    def step(state, points, label_onehot):
        pcl, covs, _, _, _ = prep(points, None)
        logits = state.model.train()(pcl, covs, return_logits=True)
        loss = cross_entropy_loss(logits, label_onehot)
        _update(state, loss)
        with torch.no_grad():
            acc = accuracy(logits, label_onehot)
        return state, {"loss": loss.detach(), "accuracy": acc}

    def eval_step(state, points, label_onehot):
        pcl, covs, _, _, _ = prep(points, None)
        with torch.no_grad():
            logits = state.model.eval()(pcl, covs, return_logits=True)
            return {"loss": cross_entropy_loss(logits, label_onehot),
                    "accuracy": accuracy(logits, label_onehot)}

    return step, eval_step


def make_multiscale_seg_step(fine_res: int, coarse_res: int, n_classes: int,
                             search: str = "fast"):
    """(step, eval_step) for NDTNetPPSegmentation (loop.py:293-343): the
    fine and the coarse preprocessing, both tagged with the ground truth
    (gt one-hot [B, N, C+1] or int tags [B, N]); the fine state goes into
    the model for its mid-forward prune; the loss is over the fine kept
    NDs. Same signatures as ``make_classification_step``."""
    prep_fine = _make_prep(fine_res, n_classes, search)
    prep_coarse = _make_prep(coarse_res, n_classes, search)

    def forward(model, points, gt):
        p1, c1, gt1, m1, state1 = prep_fine(points, gt)
        p2, c2, _, _, _ = prep_coarse(points, gt)
        return model(p1, c1, state1, p2, c2, return_logits=True), gt1, m1

    def step(state, points, gt):
        logits, gt1, m1 = forward(state.model.train(), points, gt)
        loss = cross_entropy_loss(logits, gt1, m1)
        _update(state, loss)
        with torch.no_grad():
            acc = accuracy(logits, gt1, m1)
        return state, {"loss": loss.detach(), "accuracy": acc}

    def eval_step(state, points, gt):
        with torch.no_grad():
            logits, gt1, m1 = forward(state.model.eval(), points, gt)
            return {"loss": cross_entropy_loss(logits, gt1, m1),
                    "accuracy": accuracy(logits, gt1, m1)}

    return step, eval_step


def make_pointnet_seg_step(n_classes: int | None = None):
    """(step, eval_step) for PointNetSegmentation (loop.py:246-290): no NDT
    anywhere. ``step(state, points [B, N, 3], gt) -> (state, metrics)``
    and ``eval_step(state, points, gt) -> metrics``, gt the one-hot [B, N,
    C+1] or, with ``n_classes`` given, int class tags [B, N], one-hot
    encoded on the device by a compare (a tag outside [0, n_classes] gives
    a zero row, as ``jax.nn.one_hot``). The loss is the mean over every
    point; metrics are device scalars, so the step makes no host sync."""

    def one_hot(gt):
        if n_classes is not None and gt.dim() == 2:
            classes = torch.arange(n_classes + 1, device=gt.device)
            return (gt[..., None] == classes).to(torch.float32)
        return gt

    def step(state, points, gt):
        onehot = one_hot(gt)
        logits = state.model.train()(points, return_logits=True)
        loss = cross_entropy_loss(logits, onehot)
        _update(state, loss)
        with torch.no_grad():
            acc = accuracy(logits, onehot)
        return state, {"loss": loss.detach(), "accuracy": acc}

    def eval_step(state, points, gt):
        onehot = one_hot(gt)
        with torch.no_grad():
            logits = state.model.eval()(points, return_logits=True)
            return {"loss": cross_entropy_loss(logits, onehot),
                    "accuracy": accuracy(logits, onehot)}

    return step, eval_step
