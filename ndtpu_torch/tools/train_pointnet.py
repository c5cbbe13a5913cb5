"""PointNet (FPS baseline) segmentation trainer on the card (port of
``tools/train_pointnet.py``):

    python -m ndtpu_torch.tools.train_pointnet [--flags of TrainConfig]
    python -m ndtpu_torch.tools.train_pointnet --device cpu --epochs 1 \\
        --batch_size 2 --n_samples 512 --n_classes 4 --feature_dim 32 \\
        --synthetic_length 4 --save_every 1 --out_path build/train_pointnet

The reference's defaults (train_pointnet.py:16-27): n_samples 4160 and a
checkpoint every 10 epochs; the rest is TrainConfig's (batch 16, 28
classes, feature_dim 768, Adam at 0.034 halved every 20 epochs). It trains
PointNetSegmentation on the points themselves, no NDT: CARLA PLY trees
(``--train_path``, ``--val_path``, ``--test_path``; ``CarlaSeg``) or the
synthetic set for a split without a path. Each epoch a train and a val
pass, a checkpoint ``pointnet_<task>_<epoch>`` every ``save_every``
epochs, ``--resume <dir>`` to continue; a last eval runs the test split.
The samples are not cached (as in the JAX trainer): a CARLA split draws
new points every epoch. ``--compute_dtype`` / ``--param_dtype`` set the
model's types. ``--device_cache`` is refused: the JAX trainer accepts
and ignores it, and the port ignores no flag. ``--coordinator host:port --num_processes
P --process_id i`` run it as rank i of P processes, as
``ndtpu_torch.tools.train``.
"""
from __future__ import annotations

import sys

from ndtpu_torch.models.pointnet import PointNetSegmentation
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.tools.train import distributed, fit, per_step_epochs
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.loop import make_lr_schedule, make_pointnet_seg_step
from ndtpu_torch.train.state import create_train_state


def main(argv=None):
    """Train as the flags say; returns the final TrainState."""
    cfg = TrainConfig.from_args(argv, n_samples=4160, save_every=10)
    with distributed(cfg):
        return train(cfg)


def train(cfg):
    """``main`` inside its data group."""
    if "classification" in cfg.task:
        raise SystemExit("train_pointnet trains the segmentation task only")
    if cfg.streaming:
        raise SystemExit("--streaming: the PointNet step has no voxel search")
    if cfg.device_cache:
        raise SystemExit("--device_cache: the PointNet trainer reads its "
                         "batches from host memory")
    train_set, val_set, test_set = (
        make_dataset(cfg.n_classes, cfg.n_samples, path,
                     synthetic_length=cfg.synthetic_length, seed=seed,
                     int_labels=cfg.int_labels)
        for seed, path in enumerate((cfg.train_path, cfg.val_path,
                                     cfg.test_path)))
    schedule = make_lr_schedule(cfg.learning_rate,
                                max(1, len(train_set) // cfg.batch_size),
                                cfg.lr_decay_epochs, cfg.lr_decay_rate)
    state = create_train_state(cfg.n_classes, cfg.feature_dim, schedule,
                               seed=cfg.seed, device=cfg.device,
                               model=PointNetSegmentation, **cfg.dtypes)
    step_fn, eval_fn = make_pointnet_seg_step(cfg.n_classes)
    return fit(cfg, state, *per_step_epochs(cfg, step_fn, eval_fn, train_set),
               val_set, test_set, "pointnet", len(train_set) // cfg.batch_size)


if __name__ == "__main__":
    main(sys.argv[1:])
