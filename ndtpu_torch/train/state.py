"""Train state and checkpoints (port of ``ndtpu/train/state.py``).

A ``TrainState`` holds the model (parameters and BatchNorm buffers), its
Adam optimizer, the learning-rate schedule and the step count. The
optimizer is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8); each update runs at ``schedule(step)``, the count before the
update, as optax's ``scale_by_schedule`` reads it, while Adam's bias
correction counts the update itself (optax's count + 1). Adam keeps its
moments in the parameters' type, so bfloat16 parameters have bfloat16
moments, as optax's ``adam`` without a ``mu_dtype``.

A state's optimizer is torch's plain Adam, its rate a Python number and
its step counters on the CPU. ``make_capturable`` gives it the form that
a CUDA graph can hold (``train/loop.py::make_epoch_scan`` calls it before
its capture): the rate a device tensor (``TrainState.rate``) that
``set_rate`` fills from the host schedule before each update, the step
counters on the card. A rate written as a Python number, or counters on
the host, would be baked into a captured graph or read with a sync. An
eager step keeps the plain form, which costs it less on the card
(PERF.md, ``chip_smoke.py``'s ``adam_modes``).

A checkpoint is a directory holding ``state.pt`` (``torch.save``): the
model's ``state_dict``, the optimizer's ``state_dict`` and the step, the
JAX checkpoint's params + batch_stats + opt_state + step. Tensors keep
their types (a bfloat16 run saves and restores bfloat16).

Under a data group every rank holds the same state:
``create_train_state`` and ``restore_checkpoint`` end with
``parallel/mesh.py::broadcast_state`` (rank 0's values on every rank, in
place, the JAX trainers' ``replicate``), and each step's summed gradients
keep the ranks equal. Only rank 0 writes checkpoints (the trainers).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.parallel.mesh import broadcast_state
from ndtpu_torch.serve import init_random_
from ndtpu_torch.utils.device import capturing

CHECKPOINT_FILE = "state.pt"


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    rate: Optional[torch.Tensor] = None  # the rate tensor (make_capturable)

    def set_rate(self, step: Optional[int] = None):
        """Write ``schedule(step)`` (default: the current step) where the
        optimizer reads its rate: a fill of the rate tensor when
        capturable (no host sync), else the groups' number."""
        lr = self.schedule(self.step if step is None else step)
        if self.rate is not None:
            self.rate.fill_(lr)
            return
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad`` at the
        schedule's rate for the current step; then step + 1. Under graph
        capture the rate is not written: the graph's caller fills it
        before each replay."""
        if not capturing():
            self.set_rate()
        self.optimizer.step()
        self.step += 1


def place_adam_steps(state: TrainState) -> TrainState:
    """Point every group at the state's own rate and capturable mode, and
    put each parameter's Adam ``step`` counter where that mode reads it:
    on the parameter's device as float32 when capturable, on the CPU
    otherwise. The one place that settles an optimizer filled from
    outside (a checkpoint, a JAX state)."""
    capturable = state.rate is not None
    for group in state.optimizer.param_groups:
        group["capturable"] = capturable
        if capturable:
            group["lr"] = state.rate
        elif isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
    for p, s in state.optimizer.state.items():
        if "step" in s:
            dev = p.device if capturable else torch.device("cpu")
            s["step"] = s["step"].to(device=dev, dtype=torch.float32)
    return state


def make_capturable(state: TrainState) -> TrainState:
    """Give the state's Adam the capturable form, in place: its rate a
    float32 tensor on the parameters' device, its counters there too
    (``place_adam_steps``). A state that has it keeps it."""
    if state.rate is None:
        dev = next(state.model.parameters()).device
        state.rate = torch.full((), state.schedule(state.step),
                                dtype=torch.float32, device=dev)
        place_adam_steps(state)
    return state


def create_train_state(num_classes: int, feature_dim: int, schedule,
                       seed: int = 0, device="cuda",
                       model=NDTNetSegmentation, dtype=None,
                       param_dtype=torch.float32, **model_kw) -> TrainState:
    """A fresh ``model`` (a model class: NDTNetSegmentation,
    NDTNetClassification, NDTNetPPSegmentation, PointNetSegmentation, ...;
    ``model_kw`` go to its constructor, e.g. fine_res and coarse_res) on
    ``device`` (the card unless the caller asks for the CPU), computing in
    ``dtype`` with parameters in ``param_dtype``, with random weights from
    ``seed`` (drawn on the CPU, so every device gets the same model), and
    its optimizer (plain Adam; ``make_capturable`` for a CUDA graph),
    broadcast from rank 0 under a data group."""
    model = init_random_(model(num_classes=num_classes,
                               feature_dim=feature_dim, device=device,
                               dtype=dtype, param_dtype=param_dtype,
                               **model_kw), seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return broadcast_state(TrainState(model, optimizer, schedule))


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
    place, onto the model's device, in its types). Returns the state.

    The file is read onto the CPU; ``load_state_dict`` moves each tensor
    to its parameter's device, and ``place_adam_steps`` then puts the Adam
    counters and the rate where the state's optimizer reads them,
    whichever device wrote the checkpoint; under a data group rank 0's
    values then go to every rank (``broadcast_state``)."""
    tree = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return broadcast_state(place_adam_steps(state))
