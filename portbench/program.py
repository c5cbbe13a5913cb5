"""The system under test, ``ndtpu_torch``, as the benchmark drives it:
the entry points that every model family shares, built from a
configuration and handed the benchmark's weights. What differs between
families (the model, its train step, its pipeline) is the family's file
(``portbench/families/``). Nothing here is measured; the drivers time
the calls.
"""
from __future__ import annotations

import contextlib

import torch


def sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_state(family, cfg: dict, weights: dict, steps_per_epoch: int, device):
    """The trainer's ``TrainState`` (``create_train_state``, Adam at the
    trainer's schedule) of the family's model, with the benchmark's
    weights loaded."""
    from ndtpu_torch.train.loop import make_lr_schedule
    from ndtpu_torch.train.state import create_train_state

    schedule = make_lr_schedule(cfg["learning_rate"], steps_per_epoch,
                                cfg["lr_decay_epochs"], cfg["lr_decay_rate"])
    model, kw = family.program_model(cfg)
    state = create_train_state(cfg["n_classes"], cfg["feature_dim"], schedule,
                               device=device, model=model, **kw)
    state.model.load_state_dict({k: v.clone() for k, v in weights.items()})
    return state


@contextlib.contextmanager
def step_preps():
    """While a train step is made: each preprocessing it makes
    (``train/loop.py::_make_prep``, in the order made: fine, then coarse)
    keeps its latest NDT state, so the harness reads the state that the
    step itself produced. Yields the list of them, one dict a
    preprocessing ({"state": NDTResult} once it has run); an entry that
    is not ``armed`` keeps nothing."""
    from ndtpu_torch.train import loop

    made, orig = [], loop._make_prep

    def make(*args, **kwargs):
        prep, slot = orig(*args, **kwargs), {"armed": True}
        made.append(slot)

        def keeping(*a, **kw):
            out = prep(*a, **kw)
            if slot["armed"]:
                slot["state"] = out[4]
            return out
        return keeping

    loop._make_prep = make
    try:
        yield made
    finally:
        loop._make_prep = orig


def state_fields(st) -> dict:
    """An ``NDTResult``'s fields that the reference reads."""
    return {k: getattr(st, k) for k in ("means", "covs", "counts", "class_hist",
                                        "zyx", "min_kl", "num_valid", "voxel_size")}


@torch.no_grad()
def preprocess(cfg: dict, nds: int, points, tags=None, voxel_sizes=None):
    """The program's batched preprocessing with a train step's or the
    pipeline's arguments: (points, covs, one-hot, mask, state fields)."""
    from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state

    pcl, covs, onehot, mask, st = ndt_preprocessing_with_state(
        nds, points, tags, cfg["n_classes"], search=cfg["search"],
        fixed_voxel_sizes=voxel_sizes)
    return {"points": pcl, "covs": covs, "onehot": onehot, "mask": mask,
            "state": state_fields(st)}


def k1_name() -> str:
    """The part of K1's kernel name that the device trace shows."""
    return "segment_moments_kernel"


def count_syncs(fn) -> int:
    """Host syncs of ``fn()``, as torch's sync debug mode flags them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)
