"""First-evaluation in-band hit rate of the fast search's seeds (port of
``scripts/seed_hit_rate.py``).

    python -m ndtpu_torch.scripts.seed_hit_rate
    python -m ndtpu_torch.scripts.seed_hit_rate --device cpu --clouds 4 \\
        --n_samples 4096 --n_desired_nds 256

For each cloud distribution, how often the first evaluation of the fast
search lands in the acceptance band [n, 1.2 n]: cold, at the
geometric-mean seed (voxel.c:28-59), and warm, at the previous cloud's
accepted size (the stream regime; cloud 0 takes the last cloud's). The
distributions are bench.py's batch (``make_batch``), the clustered
stream frame (``clustered_cloud``, 64 clusters) and the uniform stress
cloud (``random_cloud``), ``--clouds`` of each. Counts, not times: the
card and the CPU give the same integers. The clouds of a distribution go
through the port's batched search together; every cloud's arithmetic is
its own.

Prints ``{"metric": "seed_hit_rate", "bench_cold": rate, ...}`` with the
JAX script's keys, each cloud's hit flags under ``"hits"`` and the
device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ndtpu_torch.core import ndt as nd
from ndtpu_torch.core import voxel as vx
from ndtpu_torch.data.synthetic import clustered_cloud, make_batch, random_cloud
from ndtpu_torch.scripts._timing import device_name
from ndtpu_torch.utils.device import resolve_device


def clamped_seed(n_desired, mins, maxs, env, seed_size=None):
    """The first evaluation's size [B]: the geometric-mean seed (or
    ``seed_size``), NaN -> 1, clipped to [max(MIN_VOXEL_GUESS, env),
    MAX_VOXEL_GUESS]."""
    s0 = (vx.estimate_voxel_size(n_desired, mins, maxs)[0]
          if seed_size is None else seed_size)
    lo = torch.clamp(env, min=nd.MIN_VOXEL_GUESS)
    return torch.clamp(torch.maximum(torch.nan_to_num(s0, nan=1.0), lo),
                       max=nd.MAX_VOXEL_GUESS)


def probe(points, n_desired: int, seed_size=None):
    """clouds [B, N, 3] -> (first evaluation in band [B] bool, accepted
    size [B] f32) of the fast search seeded at ``seed_size`` [B] (the
    geometric-mean seed when None)."""
    b, n, _ = points.shape
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    classes = torch.zeros((b, n), dtype=torch.int32, device=points.device)
    upper = int(n_desired * (1.0 + nd.DOWNSAMPLE_UPPER_THRESHOLD))
    mins, maxs = nd._limits(px, py, pz, mask)
    env = nd._min_packable_voxel_size(mins, maxs)
    s0 = clamped_seed(n_desired, mins, maxs, env, seed_size)
    c0 = nd._count_occupied(px, py, pz, mask, s0, mins, maxs)
    size, _, _ = nd._search_and_sort_fast(
        px, py, pz, mask, classes, n_desired, mins, maxs, lo_min=env,
        tagged=False, size0_override=seed_size)
    return (c0 >= n_desired) & (c0 <= upper), size


def distributions(clouds: int, n_samples: int):
    """(name, [clouds, N, 3] float32) of the three distributions."""
    return (
        ("bench", make_batch(clouds, n_samples)),
        ("clustered", np.stack([clustered_cloud(n_samples, seed=i)
                                for i in range(clouds)])),
        ("random", np.stack([random_cloud(n_samples, seed=i)
                             for i in range(clouds)])),
    )


def main(argv=None):
    """Count the hits as the flags say; prints and returns the JSON
    line's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_desired_nds", type=int, default=1000)
    p.add_argument("--n_samples", type=int, default=70000)
    p.add_argument("--clouds", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out, hits = {}, {}
    for name, clouds in distributions(args.clouds, args.n_samples):
        pts = torch.from_numpy(clouds).to(dev)
        hit, accepted = probe(pts, args.n_desired_nds)
        # warm: each cloud seeded with the previous cloud's accepted size
        warm, _ = probe(pts, args.n_desired_nds, torch.roll(accepted, 1))
        for mode, h in (("cold", hit), ("warm", warm)):
            flags = h.tolist()
            hits[f"{name}_{mode}"] = flags
            out[f"{name}_{mode}"] = float(np.mean(flags))
            print(f"[seed] {name} {mode}: first-eval in-band "
                  f"{out[f'{name}_{mode}'] * 100:.0f}% ({sum(flags)}/"
                  f"{len(flags)})", file=sys.stderr)
    result = {"metric": "seed_hit_rate", **out, "hits": hits,
              "clouds": args.clouds, "n_samples": args.n_samples,
              "n_desired_nds": args.n_desired_nds, "device": device_name(dev)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
