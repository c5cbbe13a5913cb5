"""NDT-Net trainer on the card (port of ``tools/train.py``), segmentation
or classification:

    python -m ndtpu_torch.tools.train [--flags of TrainConfig]
    python -m ndtpu_torch.tools.train --device cpu --epochs 1 \\
        --batch_size 2 --n_samples 512 --n_desired_nds 32 --n_classes 4 \\
        --feature_dim 32 --out_path build/train
    python -m ndtpu_torch.tools.train --task classification --device cpu \\
        --epochs 1 --batch_size 4 --n_samples 512 --n_desired_nds 32 \\
        --n_classes 8 --feature_dim 32 --out_path build/train_cls

Segmentation trains on CARLA PLY trees (``--train_path``, ``--val_path``,
``--test_path``; ``CarlaSeg``, the synthetic ``SyntheticSeg`` for a split
without a path); classification on a ModelNet-style tree (the same flags;
``--val_path`` equal to ``--train_path`` carves a 1-in-10 holdout out of
the train split) or, without paths, on ``SyntheticCls``, with the labels
one-hot over ``--n_classes``. Each epoch trains over the train set
(shuffled by the epoch's seed),
evaluates the val split and logs one JSON line each, saves a checkpoint
every ``save_every`` epochs (model, optimizer, step; ``--resume <dir>``
continues from one), and a last eval runs the test split. Metrics stay
device scalars summed over the epoch and are read once at its end.
``--streaming`` (segmentation only) searches each sample's voxel size
once up front and trains with the sizes fixed.

``--compute_dtype`` / ``--param_dtype`` (float32, bfloat16, float16) set
the model's types; the preprocessing stays float32. ``--device_cache``
uploads each split to the device once (``DeviceCachedDataset``; with
``--streaming`` the searched sizes are its third array) and gathers the
batches there; with ``--epoch_scan`` (the default) each epoch is
``make_epoch_scan``'s: on the card a CUDA graph of the step, replayed
once a step, with no host sync inside the epoch.

``--coordinator host:port --num_processes P --process_id i`` run the
trainer as rank i of P processes (gloo with ``--device cpu``, NCCL on
the card ``i % device_count`` otherwise), each loading its slice of every
global batch of ``--batch_size`` clouds and computing the global-batch
step (``train/loop.py``); with ``--device_cache`` each rank holds a block
of every split and ``--epoch_scan`` is required, as in the JAX trainer.
Only rank 0 logs, prints and writes checkpoints.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import sys
import time

import numpy as np
import torch

from ndtpu_torch.data.loader import (
    CachedDataset,
    DeviceCachedDataset,
    batch_iterator,
    prefetch_to_device,
)
from ndtpu_torch.data.classification import ModelNetCls
from ndtpu_torch.data.synthetic import SyntheticCls
from ndtpu_torch.models.ndtnet import NDTNetClassification, NDTNetSegmentation
from ndtpu_torch.parallel.mesh import (
    data_group,
    data_rank,
    data_size,
    init_distributed,
    release_group,
)
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.loop import (
    make_classification_step,
    make_epoch_scan,
    make_lr_schedule,
    make_ndt_seg_step,
    run_epoch_scan,
)
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


class _OneHotCls:
    """Adapter: (points, label) -> (points, one-hot [num_classes] f32)."""

    def __init__(self, ds, num_classes):
        self.ds, self.num_classes = ds, num_classes

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        pts, label = self.ds[i]
        oh = np.zeros((self.num_classes,), np.float32)
        oh[label] = 1.0
        return pts, oh


def make_cls_dataset(cfg, split, seed):
    """The classification set of ``split`` (train, val or test):
    ModelNetCls at the split's path, else SyntheticCls. When the val path
    is the train path, val is the carved holdout and train the rest, so
    model selection never reads the test split."""
    path = {"train": cfg.train_path, "val": cfg.val_path,
            "test": cfg.test_path}[split]
    if not path:
        return _OneHotCls(SyntheticCls(n_points=cfg.n_samples,
                                      length=cfg.synthetic_length, seed=seed),
                         cfg.n_classes)
    carve = bool(cfg.val_path) and cfg.val_path == cfg.train_path
    ds_split = {"train": "train+holdout" if carve else "train",
                "val": "val", "test": "test"}[split]
    ds = ModelNetCls(path, split=ds_split, n_points=cfg.n_samples, seed=seed)
    if ds.n_classes > cfg.n_classes:
        # the head has cfg.n_classes outputs: a label past them would
        # corrupt the loss
        raise ValueError(
            f"dataset at {path} has {ds.n_classes} classes but --n_classes "
            f"is {cfg.n_classes}; pass --n_classes >= {ds.n_classes}")
    return _OneHotCls(ds, cfg.n_classes)


@contextlib.contextmanager
def distributed(cfg):
    """The trainer's data group, from its flags (``init_distributed``,
    before any device is touched; ``cfg.device`` becomes this rank's
    device), released at exit. A single process makes none."""
    cfg.device = str(init_distributed(cfg.coordinator, cfg.num_processes,
                                      cfg.process_id, cfg.device))
    try:
        yield
    finally:
        if cfg.num_processes > 1:
            release_group()


def main(argv=None):
    """Train as the flags say; returns the final TrainState."""
    cfg = TrainConfig.from_args(argv)
    with distributed(cfg):
        return train(cfg)


def train(cfg):
    """``main`` inside its data group."""
    classify = "classification" in cfg.task
    if classify and cfg.streaming:
        raise SystemExit("--streaming supports the segmentation task only")
    sharding = data_group() if data_size() > 1 else None
    if cfg.device_cache and sharding is not None and not cfg.epoch_scan:
        # without the epoch scan nothing assembles a global batch from
        # the ranks' blocks
        raise SystemExit("multi-process --device_cache requires --epoch_scan")
    sets = []
    for seed, split in enumerate(("train", "val", "test")):
        if classify:
            ds = make_cls_dataset(cfg, split, seed)
        else:
            path = (cfg.train_path, cfg.val_path, cfg.test_path)[seed]
            ds = make_dataset(cfg.n_classes, cfg.n_samples, path,
                              synthetic_length=cfg.synthetic_length, seed=seed,
                              int_labels=cfg.int_labels)
        if cfg.streaming:
            ds = precompute_voxel_sizes(ds, cfg)
        if cfg.device_cache:
            ds = DeviceCachedDataset(ds, cfg.device, sharding)
        elif cfg.cache_dataset:
            ds = CachedDataset(ds)
        sets.append(ds)
    train_set, val_set, test_set = sets

    schedule = make_lr_schedule(cfg.learning_rate,
                                max(1, len(train_set) // cfg.batch_size),
                                cfg.lr_decay_epochs, cfg.lr_decay_rate)
    model, make_step = ((NDTNetClassification, make_classification_step)
                        if classify else
                        (NDTNetSegmentation, make_ndt_seg_step))
    state = create_train_state(cfg.n_classes, cfg.feature_dim, schedule,
                               seed=cfg.seed, device=cfg.device, model=model,
                               **cfg.dtypes)
    step_fn, eval_fn = make_step(cfg.n_desired_nds, cfg.n_classes, cfg.search)
    if cfg.device_cache and cfg.epoch_scan:
        epochs = scan_epochs(cfg, step_fn, eval_fn, train_set, sharding)
    else:
        epochs = per_step_epochs(cfg, step_fn, eval_fn, train_set)
    return fit(cfg, state, *epochs, val_set, test_set, "ndtnet",
               len(train_set) // cfg.batch_size)


def per_step_epochs(cfg, step_fn, eval_fn, train_set):
    """(train_epoch(state, seed), eval_epoch(state, dataset)) of the
    per-step loop (``run_epoch``) over batches from host memory
    (``batch_iterator`` + ``prefetch_to_device``; this rank's slice of
    each global batch) or, for a ``DeviceCachedDataset``, gathered on the
    device (its ``loader``)."""
    def loader(dataset, shuffle, seed=0):
        if isinstance(dataset, DeviceCachedDataset):
            return dataset.loader(cfg.batch_size, shuffle=shuffle, seed=seed)
        return prefetch_to_device(
            batch_iterator(dataset, cfg.batch_size, shuffle=shuffle, seed=seed,
                           process_id=data_rank(), num_processes=data_size()),
            cfg.device)

    def train_epoch(state, seed):
        return run_epoch(step_fn, state, loader(train_set, True, seed), True)

    def eval_epoch(state, dataset):
        return run_epoch(eval_fn, state, loader(dataset, False), False)[1]

    return train_epoch, eval_epoch


def scan_epochs(cfg, step_fn, eval_fn, train_set, sharding=None):
    """(train_epoch, eval_epoch) as ``per_step_epochs`` gives them, each
    epoch a ``make_epoch_scan`` epoch over ``DeviceCachedDataset``s (a CUDA
    graph of the step on the card), sharded over ``sharding`` if given."""
    train_scan = make_epoch_scan(step_fn, True, sharding)
    eval_scan = make_epoch_scan(eval_fn, False, sharding)

    def train_epoch(state, seed):
        return run_epoch_scan(train_scan, state, train_set, cfg.batch_size,
                              shuffle=True, seed=seed)

    def eval_epoch(state, dataset):
        return run_epoch_scan(eval_scan, state, dataset, cfg.batch_size,
                              shuffle=False)[1]

    return train_epoch, eval_epoch


def fit(cfg, state, train_epoch, eval_epoch, val_set, test_set, prefix,
        steps_per_epoch):
    """The epochs of a trainer: resume from ``cfg.resume`` if given; each
    epoch train (``train_epoch(state, epoch)``, shuffled by the epoch's
    seed), log, evaluate val (``eval_epoch(state, val_set)``), log, and
    every ``save_every`` epochs save
    ``<out_path>/<time>/<prefix>_<task>_<epoch>``; then evaluate the test
    split unless it is None. Only rank 0 of a data group logs, prints and
    saves. Returns the final state."""
    host0 = data_rank() == 0
    if cfg.resume:
        state = restore_checkpoint(state, cfg.resume)
        if host0:
            print(f"resumed from {cfg.resume} at step {state.step}")
    out_dir = os.path.join(
        cfg.out_path, datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))
    logger = MetricLogger(
        use_wandb=cfg.wandb, project=cfg.wandb_project,
        run_name=f"{cfg.task}_{datetime.datetime.now():%Y%m%d_%H%M%S}",
        config=vars(cfg),
    )

    for epoch in range(cfg.epochs):
        t_ep = time.perf_counter()
        state, m = train_epoch(state, epoch)
        ep_s = time.perf_counter() - t_ep
        clouds = steps_per_epoch * cfg.batch_size
        logger.log({**{f"train_{k}": v for k, v in m.items()},
                    "epoch_seconds": round(ep_s, 3),
                    "clouds_per_s": round(clouds / max(ep_s, 1e-9), 2)},
                   step=epoch + 1)
        logger.log({f"val_{k}": v for k, v in
                    eval_epoch(state, val_set).items()}, step=epoch + 1)
        if (epoch + 1) % cfg.save_every == 0 and host0:
            path = save_checkpoint(state, os.path.join(
                out_dir, f"{prefix}_{cfg.task}_{epoch + 1}"))
            print(f"saved checkpoint to {path}")

    if test_set is not None:
        logger.log({f"test_{k}": v for k, v in
                    eval_epoch(state, test_set).items()})
    logger.finish()
    if host0:
        print("Done.")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
