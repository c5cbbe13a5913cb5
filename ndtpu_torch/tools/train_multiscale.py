"""NDT-Net++ multiscale segmentation trainer on the card (port of
``tools/train_multiscale.py``):

    python -m ndtpu_torch.tools.train_multiscale [--flags of TrainConfig]
    python -m ndtpu_torch.tools.train_multiscale --device cpu --epochs 1 \\
        --batch_size 2 --n_samples 512 --n_desired_nds 32 \\
        --n_desired_nds1 16 --n_classes 4 --feature_dim 32 \\
        --synthetic_length 4 --out_path build/train_multiscale

Two NDT resolutions, fine ``--n_desired_nds`` (default 8160) and coarse
``--n_desired_nds1`` (4080), batch 4 and feature_dim 1024 by default
(the reference's train_multiscale.py:17-29). It trains
NDTNetPPSegmentation on CARLA PLY trees (``--train_path``, ``--val_path``)
or the synthetic segmentation set: each epoch a train
pass and a val pass, a checkpoint ``ndtnetpp_<task>_<epoch>`` every
``save_every`` epochs, ``--resume <dir>`` to continue; there is no test
split, as in the JAX trainer. Only the segmentation task has a multiscale
trainer, and each step searches both voxel sizes (no ``--streaming``).
``--compute_dtype`` / ``--param_dtype`` set the model's types.
``--device_cache`` is refused: the JAX trainer accepts and ignores it,
and the port ignores no flag. ``--coordinator host:port --num_processes
P --process_id i`` run it as rank i of P processes, as
``ndtpu_torch.tools.train``.
"""
from __future__ import annotations

import sys

from ndtpu_torch.data.loader import CachedDataset
from ndtpu_torch.models.ndtnetpp import NDTNetPPSegmentation
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.tools.train import distributed, fit, per_step_epochs
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.loop import make_lr_schedule, make_multiscale_seg_step
from ndtpu_torch.train.state import create_train_state


def main(argv=None):
    """Train as the flags say; returns the final TrainState."""
    cfg = TrainConfig.from_args(argv, n_desired_nds=8160, batch_size=4,
                                feature_dim=1024)
    with distributed(cfg):
        return train(cfg)


def train(cfg):
    """``main`` inside its data group."""
    if "classification" in cfg.task:
        raise SystemExit("train_multiscale trains the segmentation task only")
    if cfg.streaming:
        raise SystemExit("--streaming: the multiscale step searches both "
                         "voxel sizes")
    if cfg.device_cache:
        raise SystemExit("--device_cache: the multiscale trainer reads its "
                         "batches from host memory")
    fine, coarse = cfg.n_desired_nds, cfg.n_desired_nds1
    sets = []
    for seed, path in enumerate((cfg.train_path, cfg.val_path)):
        ds = make_dataset(cfg.n_classes, cfg.n_samples, path,
                          synthetic_length=cfg.synthetic_length, seed=seed,
                          int_labels=cfg.int_labels)
        sets.append(CachedDataset(ds) if cfg.cache_dataset else ds)
    train_set, val_set = sets
    schedule = make_lr_schedule(cfg.learning_rate,
                                max(1, len(train_set) // cfg.batch_size),
                                cfg.lr_decay_epochs, cfg.lr_decay_rate)
    state = create_train_state(cfg.n_classes, cfg.feature_dim, schedule,
                               seed=cfg.seed, device=cfg.device,
                               model=NDTNetPPSegmentation, fine_res=fine,
                               coarse_res=coarse, **cfg.dtypes)
    step_fn, eval_fn = make_multiscale_seg_step(fine, coarse, cfg.n_classes,
                                                cfg.search)
    return fit(cfg, state, *per_step_epochs(cfg, step_fn, eval_fn, train_set),
               val_set, None, "ndtnetpp", len(train_set) // cfg.batch_size)


if __name__ == "__main__":
    main(sys.argv[1:])
