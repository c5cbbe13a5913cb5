"""Collectives and bytes of the data-parallel segmentation step and of the
point-sharded downsample (port of ``scripts/collectives.py``).

    python -m ndtpu_torch.scripts.collectives --device cpu   # 8 gloo ranks
    python -m ndtpu_torch.scripts.collectives                # 1 NCCL rank
    python -m ndtpu_torch.scripts.collectives --device cpu --processes 2 \\
        --batch_size 4 --n_samples 512 --n_desired_nds 32 --n_classes 4 \\
        --feature_dim 32 --giant_points 4096 --giant_nds 256

The JAX script compiles both programs on a virtual 8-device CPU mesh and
reads the collectives out of the compiled HLO. The port runs them: one
step (``make_ndt_seg_step``, fast search) on a data group of
``--processes`` ranks, each rank holding ``--batch_size / --processes``
clouds of ``make_batch`` with random labels, and one
``make_point_sharded_downsample`` (reference search, as JAX's default)
of a ``--giant_points`` cloud (``default_rng(0)``, normal, scale 20)
split over the ranks, and counts on rank 0 every ``torch.distributed``
call they make (``parallel/collectives.py::Collectives``): a call in the
search's loop counts once an evaluation. The ranks are processes (gloo)
on the CPU, 8 by default (``parallel/mesh.py::run_ranks``); on the
card one NCCL rank runs in this process (``--processes 1``: the card's
machine has one card).

Prints one JSON line a program with the JAX script's keys (the op names
are ``torch.distributed``'s): the step's with ``param_bytes`` and the
gradient all-reduce's bytes (the largest all-reduce: one flat buffer of
every gradient), the downsample's with the points, the sum of its
voxel counts (the points, where the search converged: the kept table
holds every occupied voxel) and whether it converged.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.core.ndt import max_segments
from ndtpu_torch.data.synthetic import make_batch
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel.collectives import Collectives
from ndtpu_torch.scripts._timing import device_name
from ndtpu_torch.utils.device import resolve_device


def _summary(calls):
    return {op: {"count": n, "bytes": calls.nbytes[op]}
            for op, n in calls.ops.items()}


def _rank(rank: int, n: int, init_method, device_type: str, args: dict):
    """One rank: the DP step and the point-sharded downsample under
    ``Collectives``. Returns rank 0's JSON lines (other ranks: None)."""
    from ndtpu_torch.parallel.point_sharded import make_point_sharded_downsample
    from ndtpu_torch.train.loop import make_ndt_seg_step
    from ndtpu_torch.train.state import create_train_state

    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if device_type == "cuda" else torch.device("cpu"))
    b, c = args["batch_size"], args["n_classes"]
    pts = make_batch(b, args["n_samples"])
    labels = np.random.default_rng(1).integers(0, c + 1, pts.shape[:2])
    mine = slice(rank * b // n, (rank + 1) * b // n)
    group = mesh.make_data_group(dev, init_method, n, rank)
    try:
        state = create_train_state(c, args["feature_dim"], lambda _: 1e-3,
                                   device=dev)
        step, _ = make_ndt_seg_step(args["n_desired_nds"], c)
        points = torch.from_numpy(pts[mine]).to(dev)
        gt = torch.from_numpy(labels[mine].astype(np.int32)).to(dev)
        with Collectives() as dp_calls:
            _, metrics = step(state, points, gt)
            float(metrics["loss"])
        param_bytes = sum(p.numel() * p.element_size()
                          for p in state.model.parameters())

        giant = np.random.default_rng(0).normal(
            size=(args["giant_points"], 3), scale=20.0).astype(np.float32)
        fn = make_point_sharded_downsample(args["giant_nds"], group=group)
        shard = mesh.shard_points(torch.from_numpy(giant).to(dev), group)
        with Collectives() as ps_calls:
            out = fn(shard)
            counted = int(out[4].counts.sum())
            converged = bool(out[4].converged[0])
    finally:
        mesh.release_group()
    lines = None
    if rank == 0:
        s = _summary(dp_calls)
        reduces = [x.nbytes for x in dp_calls.log if x.op == "all_reduce"]
        lines = [{
            "program": "dp_train_step",
            "prep": "per rank, no collective (the JAX step's shard_map)",
            "devices": n, "param_bytes": param_bytes, "collectives": s,
            "allreduce_mb_per_step": s.get("all_reduce", {}).get("bytes", 0) / 1e6,
            "gradient_allreduce_bytes": max(reduces, default=0),
        }, {
            "program": "point_sharded_downsample", "devices": n,
            "k_max": max_segments(args["giant_nds"]),
            "collectives": _summary(ps_calls),
            "note": "calls as run: those in the search's loop once an "
                    "evaluation",
            "points": args["giant_points"], "counts_sum": counted,
            "converged": converged,
        }]
    return lines


def main(argv=None):
    """Count the collectives as the flags say; prints the JSON lines and
    returns them."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_samples", type=int, default=4096)
    p.add_argument("--n_desired_nds", type=int, default=1000)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--feature_dim", type=int, default=768)
    p.add_argument("--giant_points", type=int, default=1 << 15)
    p.add_argument("--giant_nds", type=int, default=2080)
    p.add_argument("--processes", type=int, default=None,
                   help="ranks: 8 gloo processes on the CPU, 1 NCCL rank on "
                        "the card by default")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.processes or (1 if dev.type == "cuda" else 8)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} NCCL ranks need {n} cards, have "
                           f"{torch.cuda.device_count()}")
    if args.batch_size % n or args.giant_points % n:
        p.error(f"--batch_size and --giant_points must divide by {n} ranks")
    job = {k: v for k, v in vars(args).items() if k not in ("device", "processes")}
    lines = mesh.run_ranks(_rank, n, dev.type, job)[0]
    for line in lines:
        line["device"] = device_name(dev)
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
