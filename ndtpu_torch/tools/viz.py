"""NDT downsample and prune benchmark with headless output (port of
``tools/viz.py``).

    python -m ndtpu_torch.tools.viz [--pcl_path cloud.ply] [--target1 1000]
    python -m ndtpu_torch.tools.viz --device cpu --n_points 2000 \\
        --target 64 --target1 32 --out_dir build/viz

The reference's tools/viz.py:70-143: load a cloud (a PLY file, or a
synthetic cloud of ``--n_points`` uniform points, seed 0), downsample it
with the reference search to ``--target`` NDs with ``--n_classes + 1``
class slots, once to warm up, then ``--repeats`` times on the clock (the
reference's Hz protocol, viz.py:100-107), and optionally prune the state
to ``--target1`` (:119-129). Instead of an Open3D window it writes
``downsampled.ply`` and ``pruned.ply`` (points coloured by class) into
``--out_dir``. ``--trace DIR`` records a ``torch.profiler`` trace of the
timed downsamples into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from ndtpu_torch.core.ndt import ndt_downsample, ndt_prune
from ndtpu_torch.data.ply import read_ply, write_ply
from ndtpu_torch.data.synthetic import random_cloud
from ndtpu_torch.tools._common import paint_classes
from ndtpu_torch.utils.device import resolve_device
from ndtpu_torch.utils.profiling import profile_trace, timed, wait


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pcl_path", type=str, default=None,
                   help="input PLY; synthetic 90k cloud when omitted")
    p.add_argument("--target", type=int, default=2080)
    p.add_argument("--target1", type=int, default=None,
                   help="optional second-stage prune target")
    p.add_argument("--n_points", type=int, default=90000)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--out_dir", type=str, default="out/viz")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--trace", type=str, default=None,
                   help="record a torch.profiler trace of the timed "
                        "downsample loop into this directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _write(path, out):
    pcl, _, labels, mask = out[:4]
    kept = mask[0].cpu().numpy()
    labels = labels[0].cpu().numpy()[kept]
    write_ply(path, pcl[0].cpu().numpy()[kept], colors=paint_classes(labels),
              classes=labels)
    return int(kept.sum())


def main(argv=None):
    """Run the benchmark as the flags say. Returns a dict: ``downsampled``
    (ndt_downsample's outputs), ``pruned`` (ndt_prune's, or None),
    ``downsample_s`` and ``prune_s`` (seconds a run)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.pcl_path:
        points, classes = read_ply(args.pcl_path)
    else:
        points = random_cloud(args.n_points, seed=0)
        classes = np.zeros((points.shape[0],), np.uint16)
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)[None]
    cls = torch.from_numpy(classes.astype(np.int32)).to(dev)[None]
    slots = args.n_classes + 1

    # warm-up, then the reference's Hz timing protocol
    out = ndt_downsample(pts, args.target, None, cls, num_class_slots=slots)
    wait(out)
    trace = profile_trace(args.trace) if args.trace else contextlib.nullcontext()
    with trace, timed(sync=lambda: out[0]) as t:
        for _ in range(args.repeats):
            out = ndt_downsample(pts, args.target, None, cls,
                                 num_class_slots=slots)
    dt = t["seconds"] / args.repeats
    print(f"Downsampling took {dt} seconds. ({1.0 / dt} Hz)")  # viz.py:106-107
    if args.trace:
        print(f"profiler trace written to {args.trace}")

    os.makedirs(args.out_dir, exist_ok=True)
    state = out[4]
    n = _write(os.path.join(args.out_dir, "downsampled.ply"), out)
    print(f"wrote {args.out_dir}/downsampled.ply "
          f"({n} NDs, voxel {float(state.voxel_size[0]):.4f})")

    result = {"downsampled": out, "pruned": None, "downsample_s": dt,
              "prune_s": None}
    if args.target1:
        with timed(sync=lambda: pruned[0]) as t:
            for _ in range(args.repeats):
                pruned = ndt_prune(state, args.target1)
        dt = t["seconds"] / args.repeats
        print(f"Pruning took {dt} seconds. ({1.0 / dt} Hz)")  # viz.py:127-129
        n = _write(os.path.join(args.out_dir, "pruned.ply"), pruned)
        print(f"wrote {args.out_dir}/pruned.ply ({n} NDs)")
        result.update(pruned=pruned, prune_s=dt)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
