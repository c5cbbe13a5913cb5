"""Cumulative stage times of the NDT build (port of
``scripts/stage_timing.py``).

    python -m ndtpu_torch.scripts.stage_timing                # canonical batch
    python -m ndtpu_torch.scripts.stage_timing --n_desired_nds 2080
    python -m ndtpu_torch.scripts.stage_timing --giant        # one giant cloud
    python -m ndtpu_torch.scripts.stage_timing --device cpu --batch_size 2 \\
        --n_samples 2048 --n_desired_nds 64 --inner 2 --iters 1

Each stage is a prefix of ``core/ndt.py``'s downsample, timed whole:

  sort     limits, the fast search (``_search_voxel_size_fast``, its
           counts on sorted keys), then the voxel key + payload sort at
           the accepted size (coordinates and class tags ride along)
  segsum   + the kernel's inputs (boundaries, ranks, centre shifts, tag
           columns) and the segment-moment reduction (the CUDA kernel K1
           on the card)
  moments  + the occupied voxels' coordinates and the finalised means and
           covariances
  kl       + the neighbour pairing and the closed-form KL
  emit     the full ``ndt_downsample`` (fast search, so its search sort is
           the build's sort; prune and compaction)

The batch is bench.py's ``make_batch`` (B 16 x 70000 points by default),
tagged with ``--n_classes + 1`` class slots (class 0 everywhere), as the
JAX script. ``--giant`` times the point-sharded downsample of one
``giant_cloud`` of ``--n_samples`` points (1,048,576 -> 2080 NDs by
default) on a one-rank group (NCCL on the card, gloo on the CPU), whose
prefixes are: sort (global limits, the search with the collective count,
the rank's key sort), segsum (+ ``sharded_segment_moments``: K1, the K3
table merge, one all-reduce), moments, kl, emit.

Prints ``{"metric": "stage_ms_cumulative", <stage>: ms, ...}`` with the
shape and the device; times are medians of ``--inner`` runs x
``--iters`` calls (``_timing.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.core import ndt as nd
from ndtpu_torch.core import voxel as vx
from ndtpu_torch.core.kl import INT32_MAX, neighbor_min_kl
from ndtpu_torch.core.moments import finalize_moments, segment_moments_soa
from ndtpu_torch.data.synthetic import giant_cloud, make_batch
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel import point_sharded as ps
from ndtpu_torch.scripts._timing import add_timing_flags, device_name, measure
from ndtpu_torch.utils.device import resolve_device

STAGES = ("sort", "segsum", "moments", "kl", "emit")


def _finalize(mom, voxel_size, offsets):
    """Occupied voxels' (z, y, x) from the tag sums, their centres, and
    the finalised means and covariances (``_build_state``'s middle)."""
    occupied = mom["counts"] > 0
    seg_zyx = torch.where(occupied[..., None],
                          torch.round(mom["tag_sums"]).to(torch.int32),
                          INT32_MAX)
    centres = vx.voxel_to_metric_space(
        torch.where(occupied[..., None], seg_zyx.flip(-1), 0),
        voxel_size[:, None], offsets[:, None, :])
    means, covs = finalize_moments(mom["counts"], mom["sum_shift"],
                                   mom["sum_outer"], centres)
    return seg_zyx, means, covs


def batch_prefix(stage: str, points, n_desired: int, slots: int):
    """The downsample of ``points`` [B, N, 3] up to ``stage``; returns the
    stage's last outputs."""
    if stage == "emit":
        return nd.ndt_downsample(points, n_desired, num_class_slots=slots,
                                 search="fast")
    b, n, _ = points.shape
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    classes = torch.zeros((b, n), dtype=torch.int32, device=points.device)
    tagged = slots > 1
    k_max = nd.max_segments(n_desired)
    mins, maxs = nd._limits(px, py, pz, mask)
    size, _ = nd._search_voxel_size_fast(
        n_desired, mins, maxs, nd._point_count(px, py, pz, mask),
        lo_min=nd._min_packable_voxel_size(mins, maxs))
    cols = nd._sort_payload_at(px, py, pz, mask, classes, size, mins, maxs,
                               tagged)
    if stage == "sort":
        return cols
    lens, offsets = vx.estimate_voxel_grid(mins, maxs, size)
    x = nd._moment_inputs(cols, size, lens, offsets, k_max, tagged)
    mom = segment_moments_soa(
        x["xt"], x["yt"], x["zt"], x["v"], x["seg"], k_max, classes=x["cls"],
        num_class_slots=slots if tagged else 0, tags=x["tags"])
    if stage == "segsum":
        return mom
    seg_zyx, means, covs = _finalize(mom, size, offsets)
    if stage == "moments":
        return means, covs
    return neighbor_min_kl(means, covs, mom["counts"], seg_zyx, lens)


def giant_prefix(stage: str, points, n_desired: int, group):
    """The point-sharded downsample of one cloud ``points`` [N, 3] (this
    rank's shard) up to ``stage``."""
    n = points.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=points.device)
    classes = torch.zeros(n, dtype=torch.int32, device=points.device)
    k_max = nd.max_segments(n_desired)
    mins, maxs = ps.global_limits(points, mask, group)
    size, conv = ps.search_voxel_size(group, points, mask, mins, maxs,
                                      n_desired, k_max, "probe")
    size, conv, lens, offsets = ps.accepted_grid(size, conv, mins, maxs)
    if stage == "sort":
        return ps._moment_inputs(points, mask, size, lens[0], offsets[0],
                                 k_max, classes)
    mom = ps.sharded_segment_moments(group, points, mask, size, lens[0],
                                     offsets[0], k_max, 1, classes)
    if stage == "segsum":
        return mom
    if stage == "moments":
        counts, table = mom["counts"][None], mom["table"][None]
        centres = vx.voxel_to_metric_space(
            torch.where((counts > 0)[..., None], table.flip(-1), 0),
            size[:, None], offsets[:, None, :])
        return finalize_moments(counts, mom["sum_shift"][None],
                                mom["sum_outer"][None], centres)
    state = ps.state_from_moments(mom, size, lens, offsets, conv)
    if stage == "kl":
        return state
    return nd._emit(state, n_desired)


def main(argv=None):
    """Time the stages as the flags say; prints and returns the JSON
    line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_samples", type=int, default=None,
                   help="points a cloud (70000; 1048576 with --giant)")
    p.add_argument("--n_desired_nds", type=int, default=None,
                   help="NDs a cloud (1000; 2080 with --giant)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--stages", type=str, default=",".join(STAGES),
                   help="comma-separated subset of " + ",".join(STAGES))
    p.add_argument("--giant", action="store_true",
                   help="one giant cloud, point-sharded over a one-rank group")
    add_timing_flags(p)
    args = p.parse_args(argv)
    stages = args.stages.split(",")
    bad = set(stages) - set(STAGES)
    if bad:
        p.error(f"unknown stage(s) {sorted(bad)}; choose from {list(STAGES)}")
    dev = resolve_device(args.device)
    n = args.n_samples or (1_048_576 if args.giant else 70000)
    m = args.n_desired_nds or (2080 if args.giant else 1000)
    results = {}
    group = mesh.make_group(dev) if args.giant else None
    try:
        if args.giant:
            points = torch.from_numpy(giant_cloud(n, 0)).to(dev)
            shape = {"points": n, "n_desired_nds": m, "ranks": 1}

            def prefix(stage):
                return giant_prefix(stage, points, m, group)
        else:
            points = torch.from_numpy(
                make_batch(args.batch_size, n, 0)).to(dev)
            slots = args.n_classes + 1
            shape = {"batch": args.batch_size, "points": n,
                     "n_desired_nds": m, "class_slots": slots}

            def prefix(stage):
                return batch_prefix(stage, points, m, slots)

        for stage in stages:
            t = measure(lambda: prefix(stage), dev, args.inner, args.iters)
            results[stage] = t["ms"]
            results[f"{stage}_call_ms"] = t["call_ms"]
            print(f"[stage] {stage}: {t['ms']:.4f} ms/batch (calls "
                  f"{', '.join(f'{c:.4f}' for c in t['call_ms'])})",
                  file=sys.stderr)
    finally:
        if group is not None:
            mesh.release_group()
    out = {"metric": "stage_ms_cumulative", **results, **shape,
           "giant": args.giant, "runs": args.inner * args.iters,
           "device": device_name(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
