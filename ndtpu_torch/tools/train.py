"""NDT-Net segmentation trainer on the card (port of ``tools/train.py``,
the segmentation task):

    python -m ndtpu_torch.tools.train [--flags of TrainConfig]
    python -m ndtpu_torch.tools.train --device cpu --epochs 1 \\
        --batch_size 2 --n_samples 512 --n_desired_nds 32 --n_classes 4 \\
        --feature_dim 32 --out_path build/train

Each epoch trains over the synthetic set (shuffled by the epoch's seed),
evaluates the val split and logs one JSON line each, saves a checkpoint
every ``save_every`` epochs (model, optimizer, step; ``--resume <dir>``
continues from one), and a last eval runs the test split. Metrics stay
device scalars summed over the epoch and are read once at its end.
``--streaming`` searches each sample's voxel size once up front and trains
with the sizes fixed.
"""
from __future__ import annotations

import datetime
import os
import sys
import time

import numpy as np
import torch

from ndtpu_torch.data.loader import (
    CachedDataset,
    batch_iterator,
    prefetch_to_device,
)
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.loop import make_lr_schedule, make_ndt_seg_step
from ndtpu_torch.train.metrics import MetricLogger
from ndtpu_torch.train.state import (
    create_train_state,
    restore_checkpoint,
    save_checkpoint,
)

METRICS = ("loss", "accuracy")


def run_epoch(step_fn, state, loader, train: bool):
    """One epoch; the metrics are summed on the device and read back once,
    at the end. Returns (state, {last_*, mean_*})."""
    total = dict.fromkeys(METRICS, 0.0)
    metrics = total
    n = 0
    for batch in loader:
        if train:
            state, metrics = step_fn(state, *batch)
        else:
            metrics = step_fn(state, *batch)
        n += 1
        total = {k: total[k] + metrics[k] for k in METRICS}
    if n:
        values = torch.stack([total[k] for k in METRICS]
                             + [metrics[k] for k in METRICS]).tolist()
    else:
        values = [0.0] * (2 * len(METRICS))
    k = len(METRICS)
    return state, {**{f"last_{m}": v for m, v in zip(METRICS, values[k:])},
                   **{f"mean_{m}": v / max(n, 1)
                      for m, v in zip(METRICS, values[:k])}}


class WithVoxelSizes:
    """Adapter appending a precomputed voxel size to each sample: batches
    become (points, gt, sizes [B]) and the steps skip the search."""

    def __init__(self, ds, sizes):
        self.ds, self.sizes = ds, sizes

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return (*self.ds[i], self.sizes[i])


def precompute_voxel_sizes(ds, cfg):
    """One searched preprocessing pass over the dataset, a batch at a time:
    each sample's accepted voxel size, reused by every epoch."""
    n, b = len(ds), cfg.batch_size
    sizes = np.empty((n,), np.float32)
    for s in range(0, n, b):
        idx = range(s, min(s + b, n))
        pts = torch.from_numpy(np.stack([ds[i][0] for i in idx])).to(cfg.device)
        with torch.no_grad():
            st = ndt_preprocessing_with_state(
                cfg.n_desired_nds, pts, None, cfg.n_classes, search=cfg.search,
            )[4]
        sizes[s:s + len(idx)] = st.voxel_size.cpu().numpy()
    return WithVoxelSizes(ds, sizes)


def main(argv=None):
    """Train as the flags say; returns the final TrainState."""
    cfg = TrainConfig.from_args(argv)
    out_dir = os.path.join(
        cfg.out_path, datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))

    sets = []
    for seed in (0, 1, 2):  # train, val, test
        ds = make_dataset(cfg.n_classes, cfg.n_samples,
                          synthetic_length=cfg.synthetic_length, seed=seed,
                          int_labels=cfg.int_labels)
        if cfg.streaming:
            ds = precompute_voxel_sizes(ds, cfg)
        sets.append(CachedDataset(ds) if cfg.cache_dataset else ds)
    train_set, val_set, test_set = sets

    steps_per_epoch = max(1, len(train_set) // cfg.batch_size)
    schedule = make_lr_schedule(cfg.learning_rate, steps_per_epoch,
                                cfg.lr_decay_epochs, cfg.lr_decay_rate)
    state = create_train_state(cfg.n_classes, cfg.feature_dim, schedule,
                               seed=cfg.seed, device=cfg.device)
    step_fn, eval_fn = make_ndt_seg_step(cfg.n_desired_nds, cfg.n_classes,
                                         cfg.search)
    if cfg.resume:
        state = restore_checkpoint(state, cfg.resume)
        print(f"resumed from {cfg.resume} at step {state.step}")

    logger = MetricLogger(
        use_wandb=cfg.wandb, project=cfg.wandb_project,
        run_name=f"{cfg.task}_{datetime.datetime.now():%Y%m%d_%H%M%S}",
        config=vars(cfg),
    )

    def loader(dataset, shuffle, seed=0):
        return prefetch_to_device(
            batch_iterator(dataset, cfg.batch_size, shuffle=shuffle, seed=seed),
            cfg.device)

    def eval_epoch(dataset):
        return run_epoch(eval_fn, state, loader(dataset, False), train=False)[1]

    for epoch in range(cfg.epochs):
        t_ep = time.perf_counter()
        state, m = run_epoch(step_fn, state, loader(train_set, True, epoch),
                             train=True)
        ep_s = time.perf_counter() - t_ep
        clouds = steps_per_epoch * cfg.batch_size
        logger.log({**{f"train_{k}": v for k, v in m.items()},
                    "epoch_seconds": round(ep_s, 3),
                    "clouds_per_s": round(clouds / max(ep_s, 1e-9), 2)},
                   step=epoch + 1)
        logger.log({f"val_{k}": v for k, v in eval_epoch(val_set).items()},
                   step=epoch + 1)
        if (epoch + 1) % cfg.save_every == 0:
            path = save_checkpoint(
                state, os.path.join(out_dir, f"ndtnet_{cfg.task}_{epoch + 1}"))
            print(f"saved checkpoint to {path}")

    logger.log({f"test_{k}": v for k, v in eval_epoch(test_set).items()})
    logger.finish()
    print("Done.")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
