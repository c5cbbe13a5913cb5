"""Whether what the timed path produced is correct: the numbers compared
with the plain reference (``portbench/reference``), each against its
limit in the cell's limits file.

Two stages, because the prune's cut cannot be followed independently:
K1 sums in float32 in its own order, so a KL near the cut may order the
other way in the reference, and one ND kept differently moves every
output of its cloud (through the max-pools and BatchNorm). So:

- the preprocessing: the reference searches, sums and prunes the same
  clouds itself, and is held against the NDT state that the timed
  step's or request's own preprocessing produced. ``size_gap``: the
  largest relative gap of the accepted voxel sizes, and of the sizes a
  streaming cell searched at set-up, from the reference's own search
  (exact: the search compares exact counts). ``moment_gap``:
  the largest gap of a voxel's mean (over the voxel size) or covariance
  (over its square), infinite where a voxel's point or class counts
  differ. ``kept_miss``: the share of the program's kept NDs that the
  reference's own prune does not keep.
- the model: the reference follows from the program's NDT state (its
  per-voxel moments, class counts and KLs), pruning and compacting it
  itself, so the program's own prune and emit are judged by what its
  model made of them (for NDT-Net++ the fine state is also the one
  pruned inside the forward). Training: ``loss_gap``, the
  largest relative gap of the first steps' losses; ``grad_gap``, the
  worst leaf's gap of the first gradient's norm (``loss_gap_first``, the
  first step's alone, is reported and not compared); ``update_gap``, the
  worst leaf's gap of the norm of the parameters' change over the
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (below that a leaf moves under Adam by
  round-off alone). A leaf's gap is over its reference norm or the
  median leaf's, whichever is larger. Serving: ``logit_gap``, the largest
  logit gap over the largest reference logit, infinite where the output
  mask is not the one the program's state gives.

The reference computes in float32 with TF32 off (``reference_precision``).
The control (``portbench/calibrate.py``) is the reference one precision
below the configuration's: TF32 matmuls for the model's float32 with
TF32 off, and each point's moment columns held in bfloat16 for the
preprocessing's plain float32 sums.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.reference import models as ref
from portbench.reference import ndt as rndt

QUIET_LEAF = 1e-3


@contextlib.contextmanager
def reference_precision(tf32: bool = False):
    """Matmuls in float32 (``tf32`` True: in TF32, the control's
    precision), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def kept_rows(state, n_out):
    """[B, K] bool: the voxels the ascending prune keeps."""
    counts = state["counts"]
    k = counts.shape[-1]
    to_remove = torch.clamp(state["num_valid"] - n_out, min=0).long()
    occupied = counts > 0
    by_kl = torch.sort(torch.where(occupied, state["min_kl"], float("inf")),
                       dim=-1, stable=True).indices
    rank_kept = ((torch.arange(k, device=counts.device)[None] >= to_remove[:, None])
                 & torch.gather(occupied, -1, by_kl))
    return torch.zeros_like(occupied).scatter_(-1, by_kl, rank_kept)


def prep_numbers(prog, mine, n_out):
    """(size_gap, moment_gap, (missed, kept)) of the program's state
    against the reference's of the same clouds."""
    vs = mine["voxel_size"]
    size_gap = size_gap_of(prog["voxel_size"], vs)
    same = (torch.equal(prog["counts"], mine["counts"])
            and torch.equal(prog["class_hist"], mine["class_hist"]))
    moment_gap = math.inf
    if same:
        occ = (mine["counts"] > 0)
        dm = (prog["means"] - mine["means"]).abs().amax(-1) / vs[:, None]
        dc = (prog["covs"] - mine["covs"]).abs().flatten(2).amax(-1) / vs[:, None] ** 2
        moment_gap = float(torch.where(occ, torch.maximum(dm, dc), 0.0).max())
    kp, km = kept_rows(prog, n_out), kept_rows(mine, n_out)
    if not same:
        return size_gap, moment_gap, (int(kp.sum()), int(kp.sum()))
    return size_gap, moment_gap, (int((kp & ~km).sum()), int(kp.sum()))


def _leaf_gap(prog, mine, names):
    """The worst leaf's |‖prog‖ - ‖mine‖| over max(‖mine‖, the median
    leaf's ‖mine‖)."""
    pn = {n: float(prog[n].double().norm()) for n in names}
    mn = {n: float(mine[n].double().norm()) for n in names}
    med = float(np.median(list(mn.values())))
    return max(abs(pn[n] - mn[n]) / max(mn[n], med, 1e-30) for n in names)


def learning_rate(cfg, traffic, step):
    """The trainer's staircase schedule, in float32 as it evaluates it."""
    steps_per_epoch = traffic["split"] // traffic["batch"]
    transition = max(1, cfg["lr_decay_epochs"] * steps_per_epoch)
    p = np.float32(step // transition)
    return float(np.float32(cfg["learning_rate"]) * np.power(np.float32(cfg["lr_decay_rate"]), p))


def size_gap_of(prog, mine):
    """The largest relative gap of the program's voxel sizes [B] from
    the reference's."""
    return float(((prog - mine).abs() / mine).max())


def stage_a(cfg, batches, preps, resolutions):
    """The preprocessing numbers over every check batch and resolution.
    Where the batch carries voxel sizes searched at set-up, the reference
    searches each cloud itself, untagged as the set-up does, holds the
    set-up's sizes to its own, and builds its state at its own sizes."""
    size_gap = moment_gap = 0.0
    missed = kept = 0
    with reference_precision():
        for (pts, tags, sizes), states in zip(batches, preps):
            for nds, st in zip(resolutions, states):
                own = None
                if sizes is not None:
                    own = rndt.searched_size(pts, nds)
                    size_gap = max(size_gap, size_gap_of(sizes, own))
                mine = rndt.downsample(pts, nds, tags, cfg["n_classes"], voxel_size=own)
                s, m, (a, b) = prep_numbers(st, mine, nds)
                size_gap, moment_gap = max(size_gap, s), max(moment_gap, m)
                missed, kept = missed + a, kept + b
    return {"size_gap": size_gap, "moment_gap": moment_gap,
            "kept_miss": missed / max(kept, 1)}


def follow_train(cell, weights, preps, tf32=False):
    """The reference's first steps from the given NDT states (a list a
    step, one state a resolution): (losses, first gradient, parameters
    after the last step)."""
    cfg, family = cell.cfg, cell.family
    nds = family.resolutions(cfg)
    names = [n for n, (k, _) in family.param_specs(cfg).items()
             if not k.startswith("buffer")]
    params = {n: t.detach().clone() for n, t in weights.items()}
    adam, losses, grad1 = {}, [], None
    with reference_precision(tf32):
        for step, states in enumerate(preps):
            for n in names:
                params[n] = params[n].detach().requires_grad_(True)
            logits, onehot, mask = family.reference_logits(cfg, params, states, nds, True)
            loss = ref.masked_cross_entropy(logits, onehot, mask)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {n: g.detach() for n, g in grads.items()}
            with torch.no_grad():
                ref.adam_step(params, grads, adam, learning_rate(cfg, cell.traffic, step))
            del logits, loss, grads
    return losses, grad1, {n: params[n].detach() for n in names}


def train_numbers(cell, weights, ev):
    """Every number of a training cell for the evidence ``ev`` (the
    program's, or the control's)."""
    out = stage_a(cell.cfg, ev["batches"], ev["preps"], cell.family.resolutions(cell.cfg))
    losses, grad1, params3 = follow_train(cell, weights, ev["preps"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(ev["losses"], losses)]
    out["loss_gap"], out["loss_gap_first"] = max(gaps), gaps[0]
    names = list(grad1)
    out["grad_gap"] = _leaf_gap(ev["grad1"], grad1, names)
    gnorm = {n: float(grad1[n].double().norm()) for n in names}
    med = float(np.median(list(gnorm.values())))
    moving = [n for n in names if gnorm[n] >= QUIET_LEAF * med]
    out["update_gap"] = _leaf_gap({n: ev["params3"][n] - weights[n] for n in moving},
                                  {n: params3[n] - weights[n] for n in moving}, moving)
    return out


def serve_numbers(cell, weights, ev, device):
    """Every number of a serving cell for the evidence ``ev``."""
    cfg, nds = cell.cfg, cell.cfg["serve_nds"]
    size_gap = moment_gap = logit_gap = 0.0
    missed = kept = 0
    with reference_precision(False):
        for s in ev["sample"]:
            pts = ev["pool"][s["slot"]].to(device)
            mine = rndt.downsample(pts, nds)
            a, b, (m, k) = prep_numbers(s["state"], mine, nds)
            size_gap, moment_gap = max(size_gap, a), max(moment_gap, b)
            missed, kept = missed + m, kept + k
            del mine
            with torch.no_grad():
                logits, _, mask = cell.family.reference_logits(cfg, weights, [s["state"]],
                                                               [nds], False)
            gap = float((s["logits"].float() - logits).abs().max() / logits.abs().max())
            logit_gap = max(logit_gap, gap if torch.equal(mask, s["mask"]) else math.inf)
    return {"size_gap": size_gap, "moment_gap": moment_gap,
            "kept_miss": missed / max(kept, 1), "logit_gap": logit_gap}


def numbers(cell, weights, ev, device):
    if ev["kind"] == "train":
        return train_numbers(cell, weights, ev)
    return serve_numbers(cell, weights, ev, device)


def verdict(values, limits):
    """(correct, [(name, value, limit)]): every number within its limit
    (a NaN never is)."""
    rows = [(n, values[n], limits[n]) for n in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
