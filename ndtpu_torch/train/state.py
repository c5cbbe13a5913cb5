"""Train state and checkpoints (port of ``ndtpu/train/state.py``).

A ``TrainState`` holds the model (parameters and BatchNorm buffers), its
Adam optimizer, the learning-rate schedule and the step count. The
optimizer is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8); each update runs at ``schedule(step)``, the count before the
update, as optax's ``scale_by_schedule`` reads it, while Adam's bias
correction counts the update itself (optax's count + 1).

A checkpoint is a directory holding ``state.pt`` (``torch.save``): the
model's ``state_dict``, the optimizer's ``state_dict`` and the step, the
JAX checkpoint's params + batch_stats + opt_state + step.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.serve import init_random_

CHECKPOINT_FILE = "state.pt"


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad`` at the
        schedule's rate for the current step; then step + 1."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(num_classes: int, feature_dim: int, schedule,
                       seed: int = 0, device="cuda",
                       model=NDTNetSegmentation, **model_kw) -> TrainState:
    """A fresh ``model`` (a model class: NDTNetSegmentation,
    NDTNetClassification, NDTNetPPSegmentation, PointNetSegmentation, ...;
    ``model_kw`` go to its
    constructor, e.g. fine_res and coarse_res) on ``device`` (the card
    unless the caller asks for the CPU), with random weights from ``seed``
    (drawn on the CPU, so every device gets the same model), and its
    optimizer."""
    model = init_random_(model(num_classes=num_classes,
                               feature_dim=feature_dim, device=device,
                               **model_kw), seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, optimizer, schedule)


def save_checkpoint(state: TrainState, path: str) -> str:
    """Write the model, optimizer and step into the directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()},
               os.path.join(path, CHECKPOINT_FILE))
    return path


def restore_checkpoint(state: TrainState, path: str) -> TrainState:
    """Load a checkpoint written by ``save_checkpoint`` into ``state`` (in
    place, onto the model's device). Returns the state.

    The file is read onto the CPU: ``load_state_dict`` moves each tensor
    to its parameter's device, but leaves Adam's ``step`` counters on the
    CPU, where the update reads them without waiting for the card."""
    tree = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state
