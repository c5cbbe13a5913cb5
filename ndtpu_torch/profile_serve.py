"""Where one canonical serving request spends its time on the card.

    python -m ndtpu_torch.profile_serve [--out build/profile_serve.json]

Two views of a request of 16 x 70000-point clouds to 1000 NDs, 28 classes,
feature_dim 768, after warm-up:

- stages: the request's steps run one after another with a CUDA event
  between them (host copy, limits + probe, the search with its sorts, the
  moments kernel + KL, the prune, the model). The events sit on the
  stream, so a stage's time includes any wait for the host before its
  first kernel.
- kernels: torch.profiler over one whole request: device time by kernel
  name, the number of kernels, and the device's idle share (1 - kernel
  time / request wall time).

Prints a summary and writes it as JSON to --out.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import time

import torch

from ndtpu_torch.core import ndt
from ndtpu_torch.data.synthetic import make_batch
from ndtpu_torch.serve import SegmentationPipeline

B, N, M, C, F = 16, 70000, 1000, 28, 768


def stages(pipe, host_points):
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark("start")
    points = torch.as_tensor(host_points, device="cuda")
    mark("host copy")
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool, device="cuda")
    classes = torch.zeros(px.shape, dtype=torch.int32, device="cuda")
    mins, maxs = ndt._limits(px, py, pz, mask)
    env = ndt._min_packable_voxel_size(mins, maxs)
    seed = ndt._probe_seed_size(px, py, pz, mask, M, mins, maxs, env)
    mark("limits + probe")
    size, conv, cols = ndt._search_and_sort_fast(
        px, py, pz, mask, classes, M, mins, maxs, env, tagged=False,
        size0_override=seed,
    )
    mark("search + sorts")
    state = ndt._build_state(px, py, pz, mask, classes, 1, size, conv, mins,
                             maxs, ndt.max_segments(M), presorted=cols)
    mark("moments kernel + KL")
    pcl, covs, _, _ = ndt._emit(state, M)
    mark("prune + compaction")
    pipe.model(pcl, covs, return_logits=True)
    mark("model")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    out = {name: marks[i][1].elapsed_time(e) for i, (name, e)
           in enumerate(marks[1:])}
    return out, wall


def kernels(pipe, host_points):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe(host_points)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "request_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else None,
        "device_idle_share": 1 - busy_us / wall_us if by_name else None,
        "kernels": sum(n for n, _ in by_name.values()),
        "top": [{"name": k[:90], "count": n, "ms": t / 1e3}
                for k, (n, t) in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_serve.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = SegmentationPipeline(M, C, F, device="cuda")
    pts = make_batch(B, N, seed=1)
    for _ in range(2):
        pipe(pts)
    runs = [stages(pipe, pts) for _ in range(5)]
    stage_ms = {k: sorted(r[0][k] for r in runs)[2] for k in runs[0][0]}
    result = {
        "device": torch.cuda.get_device_name(0),
        "stages_ms_median_of_5": stage_ms,
        "stages_wall_ms_median_of_5": sorted(r[1] for r in runs)[2],
        "profile": kernels(pipe, pts),
    }
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
