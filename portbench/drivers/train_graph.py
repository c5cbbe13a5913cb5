"""The trainer with ``--device_cache`` and the epoch scan
(``tools/train.py::scan_epochs``): the split resident on the card, each
epoch ``run_epoch_scan`` over ``make_epoch_scan``'s CUDA graph of the
step, whole shuffled epochs back to back. With ``streaming`` in the
traffic, each cloud's voxel size is searched once at set-up
(``tools/train.py::precompute_voxel_sizes``) and the step trains with it
fixed."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.training import CHECK_STEPS, Train


class DeviceSet:
    """The split resident on the card, as ``DeviceCachedDataset`` holds it
    (one tensor per field), for ``run_epoch_scan``."""

    sharding = None

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return self.arrays[0].shape[0]


class Driver(Train):
    def setup(self):
        from ndtpu_torch.train.loop import make_epoch_scan

        arrays = (self.points, self.tags)
        if self.traffic.get("streaming"):
            # precompute_voxel_sizes: one searched, untagged pass over the
            # split, a batch at a time (a step of one resolution only)
            (nds,), sizes = self.family.resolutions(self.cfg), []
            for s in range(0, self.split, self.batch):
                sizes.append(program.preprocess(
                    self.cfg, nds, self.points[s:s + self.batch])["state"]["voxel_size"])
            self.sizes = torch.cat(sizes)
            arrays += (self.sizes,)
        self.data = DeviceSet(arrays)
        self.scan = make_epoch_scan(self.step_fn, True)
        rows = inputs.host_rng(self.seed, 3).permutation(self.split)
        for k in range(CHECK_STEPS):
            self.check_rows.append(rows[k * self.batch:(k + 1) * self.batch])
            order = torch.as_tensor(self.check_rows[-1][None], device=self.device)
            self.state, _, last = self.scan(self.state, order, *arrays)
            self.record(k, last)
        program.sync(self.device)

    def window(self, seconds):
        from ndtpu_torch.train.loop import run_epoch_scan

        epochs, bad, t0 = 0, 0, time.perf_counter()
        while True:
            with torch.profiler.record_function("portbench.epoch"):
                self.state, m = run_epoch_scan(self.scan, self.state, self.data,
                                               self.batch, shuffle=True,
                                               seed=self.epoch_seed(epochs))
            bad += not np.isfinite(m["mean_loss"])
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        program.sync(self.device)
        elapsed = time.perf_counter() - t0
        clouds = epochs * self.steps_per_epoch * self.batch
        return {"elapsed": elapsed, "steps": epochs * self.steps_per_epoch,
                "attempted": clouds, "failed": bad * self.steps_per_epoch * self.batch,
                "e2e": {"train_clouds_per_s": clouds / elapsed}}

    def traced_block(self):
        """One whole epoch."""
        self.window(0.0)
