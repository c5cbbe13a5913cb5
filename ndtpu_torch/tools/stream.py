"""Frame-stream inference on the card (port of ``tools/stream.py``): the
serving regime of a sensor stream.

    python -m ndtpu_torch.tools.stream [--checkpoint <dir>] [--mode warm|fixed]
    python -m ndtpu_torch.tools.stream --device cpu --n_frames 6 \\
        --n_points 2048 --n_desired_nds 48 --n_classes 4 --out_dir build/stream

Consecutive frames of a sensor stream share their statistics, so the
voxel-size search, roughly half of the preprocessing, runs on the first
frame only: later frames reuse its accepted size.

- ``--mode warm`` (the default): each frame seeds the fast search with the
  last accepted size (``warm_start_size``), so a frame that drifted out of
  the band finds its way back within its own downsample; the steady state
  is one voxelisation a frame.
- ``--mode fixed``: each frame voxelises at the fixed size
  (``fixed_voxel_size``) and the host watches the band: a frame whose
  occupied-voxel count (``num_valid``) left [n_desired, 1.2 n_desired]
  (ndt.h:38) is emitted as it is, and the next frame searches anew.

``--research_every K`` also forces a full search every K frames. Input:
a directory of PLY frames (sorted name order is stream order) or a
synthetic drifting stream. ``--checkpoint``: a port segmentation trainer
checkpoint (``python -m ndtpu_torch.tools.train``), whose model (built
with the checkpoint's own widths) colours each frame's NDs; without one
the NDs carry their voxel labels. ``--out_dir`` writes each frame's NDs as
a coloured PLY.

Timing: a frame's clock runs from its downsample's launch (after the
upload) to the readback of its ``num_valid``, the one host readback of a
frame's downsample; the model and its argmax readback come after it, as
in the JAX tool. The last line
is the JAX tool's JSON: frame counts, the mean, and the steady ms a frame
and Hz over the frames after the first two.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ndtpu_torch.core.ndt import DOWNSAMPLE_UPPER_THRESHOLD, ndt_downsample
from ndtpu_torch.data.ply import read_ply, write_ply
from ndtpu_torch.tools._common import (
    checkpoint_widths,
    paint_classes,
    segmentation_model,
)
from ndtpu_torch.utils.device import resolve_device


def synthetic_stream(n_frames, n_points, seed=0):
    """Drifting clustered scene: 256 cluster centres translate a little a
    frame (a stand-in for a vehicle-mounted sensor)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-15, 15, size=(256, 3))
    per = n_points // 256 + 1
    for f in range(n_frames):
        drift = np.array([0.4 * f, 0.15 * f, 0.0])
        pts = (
            (centers + drift)[:, None, :]
            + rng.normal(scale=0.35, size=(256, per, 3))
        ).reshape(-1, 3)[:n_points].astype(np.float32)
        yield pts


def frame_iter(args):
    if args.frames_path:
        names = sorted(
            n for n in os.listdir(args.frames_path) if n.endswith(".ply")
        )
        for n in names:
            pts, _ = read_ply(os.path.join(args.frames_path, n))
            yield pts.astype(np.float32)
    else:
        yield from synthetic_stream(args.n_frames, args.n_points)


def downsample_frame(points, n_desired, mode, size, search):
    """One frame's downsample: the full ``search`` when ``size`` is None,
    else the warm-started fast search or the fixed size. points [1, N, 3]
    on the device; size the last accepted size [1] or None. Returns
    (ndt_downsample's outputs, the mode's name)."""
    if size is None:
        return ndt_downsample(points, n_desired, search=search), "search"
    if mode == "warm":
        return ndt_downsample(points, n_desired, search="fast",
                              warm_start_size=size), "warm"
    return ndt_downsample(points, n_desired, fixed_voxel_size=size), "fixed"


def classify(model, pcl, covs):
    """The model's class for each of a frame's NDs: the argmax of its
    logits, read back once. pcl [1, M, 3], covs [1, M, 9]."""
    with torch.no_grad():
        logits = model(pcl, covs, return_logits=True)
    return logits[0].argmax(-1).cpu().numpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames_path", type=str, default=None,
                   help="directory of PLY frames; synthetic stream if unset")
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--n_points", type=int, default=70000)
    p.add_argument("--n_desired_nds", type=int, default=1000)
    p.add_argument("--n_classes", type=int, default=28,
                   help="the model's classes without a checkpoint's own")
    p.add_argument("--feature_dim", type=int, default=768,
                   help="the model's width without a checkpoint's own")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="port segmentation trainer checkpoint directory to "
                        "run on each frame's NDs")
    p.add_argument("--search", type=str, default="probe",
                   choices=["fast", "probe", "reference", "grid"])
    p.add_argument("--mode", type=str, default="warm",
                   choices=["warm", "fixed"],
                   help="'warm': each frame seeds the fast search with the "
                        "last accepted size, so a drifted frame heals within "
                        "its own downsample; 'fixed': the fixed size and a "
                        "host-side band monitor, an out-of-band frame "
                        "searched anew one frame late")
    p.add_argument("--research_every", type=int, default=0,
                   help="force a full voxel-size search every K frames (0: "
                        "never force)")
    p.add_argument("--out_dir", type=str, default=None,
                   help="write each frame's NDs as a coloured PLY here")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Run the stream as the flags say. Prints a line a frame on stderr
    and the stats JSON on stdout. Returns (stats, one record a frame:
    mode, valid, in_band, ms, voxel_size)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    m = args.n_desired_nds
    upper = int(m * (1.0 + DOWNSAMPLE_UPPER_THRESHOLD))

    model = None
    if args.checkpoint:
        n_classes, feature_dim = checkpoint_widths(args.checkpoint)
        model = segmentation_model(n_classes, feature_dim, dev,
                                   args.checkpoint)
        print(f"[stream] model of {args.checkpoint}: {n_classes} classes, "
              f"feature_dim {feature_dim}", file=sys.stderr)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    size = None
    frames, sizes = [], []
    for i, pts in enumerate(frame_iter(args)):
        if args.research_every and i % args.research_every == 0:
            size = None
        pts_d = torch.from_numpy(pts).to(dev)[None]
        t0 = time.perf_counter()
        (pcl, covs, labels, mask, state), mode = downsample_frame(
            pts_d, m, args.mode, size, args.search)
        valid = int(state.num_valid[0])  # device sync: the frame is done
        t_frame = time.perf_counter() - t0
        in_band = m <= valid <= upper
        if mode != "fixed":
            size = state.voxel_size  # the accepted size, threaded forward
        if not in_band and args.mode == "fixed":
            size = None  # drifted out of the acceptance band: re-search
        pred = (classify(model, pcl, covs) if model is not None
                else labels[0].cpu().numpy())
        if args.out_dir:
            keep = mask[0].cpu().numpy()
            write_ply(os.path.join(args.out_dir, f"frame_{i:04d}.ply"),
                      pcl[0].cpu().numpy()[keep],
                      colors=paint_classes(pred[keep]))
        frames.append({"mode": mode, "valid": valid, "in_band": in_band,
                       "ms": t_frame * 1e3})
        sizes.append(state.voxel_size)
        print(f"[stream] frame {i}: {mode} voxels={valid} "
              f"{'OK' if in_band else 'OUT-OF-BAND -> re-search'} "
              f"{t_frame * 1000:.1f} ms", file=sys.stderr)

    for f, vs in zip(frames, torch.cat(sizes).tolist() if sizes else []):
        f["voxel_size"] = vs  # read back once, after the stream
    times = [f["ms"] / 1e3 for f in frames]
    n = len(frames)
    n_search = sum(f["mode"] == "search" for f in frames)
    # steady state leaves out the first two frames (the search and the
    # first frame of the mode)
    steady = times[2:] or times
    stats = {
        "frames": n,
        "searched_frames": n_search,
        "fixed_frames": n - n_search,
        "mean_ms_per_frame": round(sum(times) / max(n, 1) * 1000, 2),
        "steady_ms_per_frame": round(sum(steady) / len(steady) * 1000, 2),
        "steady_hz": round(len(steady) / sum(steady), 2),
    }
    print(json.dumps(stats))
    return stats, frames


if __name__ == "__main__":
    main(sys.argv[1:])
