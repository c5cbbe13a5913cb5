"""Hyperparameter search over the NDT-Net segmentation trainer (port of
``tools/hyperparameter_search.py``).

    python -m ndtpu_torch.tools.hyperparameter_search [--n_trials 10]
    python -m ndtpu_torch.tools.hyperparameter_search --device cpu \\
        --n_trials 2 --epochs 1 --n_samples 256 --n_desired_nds 16 \\
        --n_classes 4 --feature_dim 32

The reference's tools/hyperparameter_search.py:23-98: a study minimising
the last batch's train loss after ``--epochs`` epochs, over the space of
its :29-31 (optimizer Adam or SGD, batch size 2-10, learning rate 1e-5 to
1e-1, log-uniform). optuna runs the study when it is installed; without
it a seeded random search of the same space runs, its trials drawn from
``numpy.random.default_rng(--seed)`` in the JAX tool's order, so a seed
gives the JAX tool's trials.

Each trial trains a fresh ``NDTNetSegmentation`` (random weights from
seed 0) on the synthetic set (or CarlaSeg under ``--train_path``) with the
port's ``make_ndt_seg_step`` and the trainer's ``run_epoch`` (one readback
an epoch), at a constant rate: Adam is ``torch.optim.Adam(lr, betas=(0.9,
0.999), eps=1e-8)``, SGD ``torch.optim.SGD(lr)`` without momentum, as
``optax.adam`` and ``optax.sgd``. One process on ``--device``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ndtpu_torch.data.loader import batch_iterator, prefetch_to_device
from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.serve import init_random_
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.tools.train import run_epoch
from ndtpu_torch.train.loop import make_ndt_seg_step
from ndtpu_torch.train.state import TrainState
from ndtpu_torch.utils.device import resolve_device


def make_optimizer(name, params, lr):
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.SGD(params, lr=lr)


def objective_factory(args):
    """objective(optimizer_name, batch_size, lr) -> the last batch's train
    loss after ``args.epochs`` epochs."""
    dev = resolve_device(args.device)
    train_set = make_dataset(args.n_classes, args.n_samples, args.train_path,
                             int_labels=True)
    step_fn, _ = make_ndt_seg_step(args.n_desired_nds, args.n_classes,
                                   args.search)

    def objective(optimizer_name: str, batch_size: int, lr: float) -> float:
        model = init_random_(NDTNetSegmentation(
            num_classes=args.n_classes, feature_dim=args.feature_dim,
            device=dev), 0)
        state = TrainState(model, make_optimizer(optimizer_name,
                                                 model.parameters(), lr),
                           lambda _: lr)
        loss = float("inf")
        for epoch in range(args.epochs):  # 10-epoch budget (reference :84)
            loader = prefetch_to_device(
                batch_iterator(train_set, batch_size, shuffle=True,
                               seed=epoch), dev)
            state, m = run_epoch(step_fn, state, loader, train=True)
            loss = m["last_loss"]  # the reference's final-batch loss metric
        return loss

    return objective


def random_trials(seed, n_trials):
    """The fallback's trials: the JAX tool's draws from
    ``np.random.default_rng(seed)``, in its order."""
    rng = np.random.default_rng(seed)
    for _ in range(n_trials):
        yield {
            "optimizer": rng.choice(["Adam", "SGD"]),
            "batch_size": int(rng.integers(2, 11)),
            "learning_rate": float(10 ** rng.uniform(-5, -1)),
        }


def main(argv=None):
    """Run the study as the flags say. Returns (best loss, best params)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--n_desired_nds", type=int, default=256)
    p.add_argument("--n_samples", type=int, default=2048)
    p.add_argument("--n_classes", type=int, default=8)
    p.add_argument("--feature_dim", type=int, default=128)
    p.add_argument("--n_trials", type=int, default=10)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--search", type=str, default="fast",
                   choices=["fast", "probe", "reference", "grid"])
    p.add_argument("--use_pallas", action="store_true", default=None,
                   help="refused: the tensors' device picks the kernel")
    p.add_argument("--no_pallas", dest="use_pallas", action="store_false",
                   help="refused: the tensors' device picks the kernel")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.use_pallas is not None:
        raise NotImplementedError(
            "--use_pallas/--no_pallas: the tensors' device picks the route "
            "(the CUDA kernel on the card, its plain version on the CPU)")

    objective = objective_factory(args)

    try:
        import optuna
    except ImportError:
        print("optuna unavailable; running seeded random search",
              file=sys.stderr)
    else:
        def optuna_objective(trial):
            return objective(
                trial.suggest_categorical("optimizer", ["Adam", "SGD"]),
                trial.suggest_int("batch_size", 2, 10),
                trial.suggest_float("learning_rate", 1e-5, 1e-1, log=True),
            )

        study = optuna.create_study(direction="minimize")
        study.optimize(optuna_objective, n_trials=args.n_trials)
        print("best:", study.best_params, "loss:", study.best_value)
        return study.best_value, study.best_params

    best = (float("inf"), None)
    for trial, params in enumerate(random_trials(args.seed, args.n_trials)):
        loss = objective(params["optimizer"], params["batch_size"],
                         params["learning_rate"])
        print(f"trial {trial}: {params} -> loss {loss:.4f}")
        if loss < best[0]:
            best = (loss, params)
    print("best:", best[1], "loss:", best[0])
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
