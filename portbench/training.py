"""What the training drivers (``portbench/drivers/train_*.py``) share: the
split and the weights made from the seed, the program's train state and
step, and the record of the first ``CHECK_STEPS`` steps that the judge
reads. Those steps go through the window's own call, on rows that all
differ; after each the record keeps its loss and the NDT state that the
step's own preprocessing produced (``program.step_preps``); after the
first, the gradient as Adam holds it; after the last, the parameters.
"""
from __future__ import annotations

import time

import torch

from portbench import inputs, program

CHECK_STEPS = 3


class Train:
    kind = "train"
    sizes = None  # [split] voxel sizes searched at set-up (streaming)

    def __init__(self, cell, seed, device):
        cfg, traffic = cell.cfg, cell.traffic
        self.cfg, self.traffic, self.family = cfg, traffic, cell.family
        self.seed, self.device = seed, device
        self.batch, self.split = traffic["batch"], traffic["split"]
        self.steps_per_epoch = self.split // self.batch
        t = [time.perf_counter()]
        self.weights = inputs.weights(self.family.param_specs(cfg), seed, device)
        self.points, self.tags = inputs.clouds(seed, self.split, cfg["n_points"],
                                               cfg["n_classes"], device)
        program.sync(device)
        t.append(time.perf_counter())
        self.state = program.train_state(self.family, cfg, self.weights,
                                         self.steps_per_epoch, device)
        with program.step_preps() as made:
            self.step_fn = self.family.train_step(cfg)
        self.made = made
        program.sync(device)
        t.append(time.perf_counter())
        self.phases = {"inputs": t[1] - t[0], "program": t[2] - t[1]}
        self.check_rows, self.preps, self.losses = [], [], []
        self.grad1 = self.params3 = None

    def epoch_seed(self, epoch):
        return int(inputs.host_rng(self.seed, 4 + epoch).integers(2**31))

    def record(self, k, metrics):
        """After check step k: its loss and its preprocessing's NDT
        states; after the first, the gradient Adam got (its first moment
        / (1 - b1)); after the last, the parameters, and the step's
        preprocessing stops keeping its state."""
        self.losses.append(metrics["loss"].detach().clone())
        self.preps.append([{n: t.clone() for n, t in
                            program.state_fields(slot["state"]).items()}
                           for slot in self.made])
        params = dict(self.state.model.named_parameters())
        if k == 0:
            opt = self.state.optimizer.state
            self.grad1 = {n: opt[p]["exp_avg"].detach() / (1 - 0.9) if p in opt
                          else torch.zeros_like(p.detach()) for n, p in params.items()}
        if k == CHECK_STEPS - 1:
            self.params3 = {n: p.detach().clone() for n, p in params.items()}
            for slot in self.made:
                slot["armed"] = False
                slot.pop("state", None)

    def evidence(self):
        """The check batches (points, tags, and the voxel sizes searched
        at set-up, or None) and the NDT states the steps produced."""
        batches = []
        for rows in self.check_rows:
            idx = torch.as_tensor(rows, device=self.device)
            sizes = None if self.sizes is None else self.sizes[idx]
            batches.append((self.points[idx], self.tags[idx], sizes))
        return {"kind": "train", "batches": batches, "preps": self.preps,
                "losses": [float(v) for v in self.losses],
                "grad1": self.grad1, "params3": self.params3}

    def release(self):
        """Drop the program's state, keeping only what the judge reads."""
        self.state = self.step_fn = None
        self.__dict__.pop("scan", None)
        self.__dict__.pop("loader", None)
