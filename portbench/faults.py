"""Faults planted in the program for the check of ``correct``: each a
context that breaks the timed path underneath the harness (by replacing
a function of the program for its duration), so a run inside it must
come out not correct.

- ``state_unchanged``: a train step that leaves its state as it was (the
  optimizer never steps).
- ``half_batch``: half of the batch left out, the mean taken over the
  rest (training: the loss over the first half of the clouds; serving:
  the pipeline segments the first half and repeats it for the rest).
- ``altered_answer``: one ND's logits of a request rolled by one class
  where the pipeline produces them (its answer changes).
- ``altered_state``: a train step's preprocessing hands on an NDT state
  whose voxel means are moved by a twentieth of the voxel size (the
  step's model inputs as they were).
- ``coarse_sizes``: a streaming cell's set-up search returns each voxel
  size a quarter too large.

The exchange between chips has no fault here: every cell runs on one.
"""
from __future__ import annotations

import contextlib

TRAIN_FAULTS = ("state_unchanged", "half_batch", "altered_state")
SERVE_FAULTS = ("half_batch", "altered_answer")
STREAMING_FAULTS = ("coarse_sizes",)


@contextlib.contextmanager
def _replaced(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    from ndtpu_torch.train.state import TrainState

    def make(orig):
        def apply_gradients(self):
            self.step += 1
        return apply_gradients
    return _replaced(TrainState, "apply_gradients", make)


def half_batch_train():
    from ndtpu_torch.train import loop

    def make(orig):
        def loss_and_metrics(logits, onehot, mask=None):
            b = logits.shape[0] // 2
            return orig(logits[:b], onehot[:b], None if mask is None else mask[:b])
        return loss_and_metrics
    return _replaced(loop, "loss_and_metrics", make)


def half_batch_serve():
    import torch

    from ndtpu_torch.serve import SegmentationPipeline

    def make(orig):
        def call(self, points):
            b = points.shape[0]
            logits, mask, st = orig(self, points[:b // 2])
            rep = (lambda t: torch.cat([t, t], 0)[:b])
            for f in ("means", "covs", "counts", "class_hist", "zyx", "min_kl",
                      "max_kl", "lens", "offsets", "voxel_size", "num_valid",
                      "converged"):
                setattr(st, f, rep(getattr(st, f)))
            return rep(logits), rep(mask), st
        return call
    return _replaced(SegmentationPipeline, "__call__", make)


def altered_answer():
    from ndtpu_torch.serve import SegmentationPipeline

    def make(orig):
        def call(self, points):
            logits, mask, st = orig(self, points)
            logits = logits.clone()
            logits[0, 0] = logits[0, 0].roll(1)
            return logits, mask, st
        return call
    return _replaced(SegmentationPipeline, "__call__", make)


def altered_state():
    from ndtpu_torch.train import loop

    def make(orig):
        def make_prep(*args, **kwargs):
            prep = orig(*args, **kwargs)

            def altered(*a, **kw):
                out = prep(*a, **kw)
                st = out[4]
                st.means = st.means + 0.05 * st.voxel_size[:, None, None]
                return out
            return altered
        return make_prep
    return _replaced(loop, "_make_prep", make)


def coarse_sizes():
    from ndtpu_torch.preprocessing import batch

    def make(orig):
        def prep(n, points, gt=None, *args, fixed_voxel_sizes=None, **kwargs):
            out = orig(n, points, gt, *args, fixed_voxel_sizes=fixed_voxel_sizes, **kwargs)
            if gt is None and fixed_voxel_sizes is None:
                out[4].voxel_size = out[4].voxel_size * 1.25
            return out
        return prep
    return _replaced(batch, "ndt_preprocessing_with_state", make)


PLANTS = {("state_unchanged", "train"): state_unchanged,
          ("half_batch", "train"): half_batch_train,
          ("half_batch", "serve"): half_batch_serve,
          ("altered_answer", "serve"): altered_answer,
          ("altered_state", "train"): altered_state,
          ("coarse_sizes", "train"): coarse_sizes}


def plant(name: str, kind: str):
    """The context of fault ``name`` for a driver of ``kind`` ("train" or
    "serve")."""
    if (name, kind) not in PLANTS:
        raise ValueError(f"no fault {name!r} for a {kind} cell")
    return PLANTS[name, kind]()
