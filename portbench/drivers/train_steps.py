"""The per-step trainer (``tools/train.py::per_step_epochs``): batches
from host memory through ``batch_iterator`` and ``prefetch_to_device``,
one eager step each."""
from __future__ import annotations

import itertools
import time

import torch

from portbench import program
from portbench.training import CHECK_STEPS, Train


class HostSet:
    """The split in host memory, indexable as the trainer's datasets are:
    item i -> (points [N, 3], class tags [N])."""

    def __init__(self, points, tags):
        self.points, self.tags = points, tags

    def __len__(self):
        return len(self.points)

    def __getitem__(self, i):
        return self.points[i], self.tags[i]


class Driver(Train):
    def setup(self):
        from ndtpu_torch.data.loader import batch_iterator, epoch_order, prefetch_to_device

        self.host = HostSet(self.points.cpu().numpy(), self.tags.cpu().numpy())

        def batches():
            for e in itertools.count():
                yield from prefetch_to_device(batch_iterator(
                    self.host, self.batch, shuffle=True, seed=self.epoch_seed(e)),
                    self.device)

        self.loader = batches()
        order = epoch_order(self.split, True, self.epoch_seed(0))
        for k in range(CHECK_STEPS):
            self.check_rows.append(order[k * self.batch:(k + 1) * self.batch])
            self.state, m = self.step_fn(self.state, *next(self.loader))
            self.record(k, m)
        program.sync(self.device)

    def step(self):
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.load"):
            batch = next(self.loader)
        waited = time.perf_counter() - t
        with torch.profiler.record_function("portbench.step"):
            self.state, m = self.step_fn(self.state, *batch)
        return waited, m["loss"]

    def window(self, seconds, steps=None):
        n, waited, losses, t0 = 0, 0.0, [], time.perf_counter()
        while (time.perf_counter() - t0 < seconds) if steps is None else n < steps:
            w, loss = self.step()
            waited += w
            losses.append(loss)
            n += 1
        program.sync(self.device)
        elapsed = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"elapsed": elapsed, "steps": n, "attempted": n * self.batch,
                "failed": bad * self.batch, "data_wait_s": waited,
                "e2e": {"train_clouds_per_s": n * self.batch / elapsed}}

    def traced_block(self):
        self.window(0.0, self.traffic["trace_steps"])

    def syncs(self):
        return program.count_syncs(self.step)
