"""Where one canonical serving request spends its time on the card.

    python -m ndtpu_torch.profile_serve [--out build/profile_serve.json]

A request of 16 x 70000-point clouds to 1000 NDs, 28 classes, feature_dim
768; after warm-up, REQUESTS requests under ``profile_trace`` (the Chrome
trace, spans and kernels, in build/profile_serve_trace/), read two ways:

- stages: the pipeline's own spans (``utils/profiling.py::span``: the
  request, the host copy, the preprocessing with its search, moments, KL
  and emit, the model), each one's device ms, the median over the
  requests. The span's events sit on the stream, so its time includes
  any wait for the host before its first kernel.
- kernels: device time by kernel name a request, kernels a request, and
  the device's idle share (1 - kernel time / wall time);
- epilogue launches: the Dense -> BatchNorm (-> ReLU) epilogue's launches
  a request, by its wrapper's count (``ops/epilogue.py``; 16 in eval).

Prints a summary and writes it as JSON to --out.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import time

import torch

from ndtpu_torch.data.synthetic import make_batch
from ndtpu_torch.ops.epilogue import dense_bn_act
from ndtpu_torch.serve import SegmentationPipeline
from ndtpu_torch.utils import profiling

B, N, M, C, F = 16, 70000, 1000, 28, 768
REQUESTS = 5


def stages(records):
    by_name = collections.defaultdict(list)
    for r in records:
        by_name[r.name].append(r.ms)
    return {k: statistics.median(v) for k, v in by_name.items()}


def kernels(prof, wall_us):
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "request_wall_ms": wall_us / 1e3 / REQUESTS,
        "device_busy_ms": busy_us / 1e3 / REQUESTS if by_name else None,
        "device_idle_share": 1 - busy_us / wall_us if by_name else None,
        "kernels": sum(n for n, _ in by_name.values()) / REQUESTS,
        "top": [{"name": k[:90], "count": n / REQUESTS, "ms": t / 1e3 / REQUESTS}
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
    torch.cuda.synchronize()
    profiling.reset()
    launches = dense_bn_act.launches
    with profiling.profile_trace("build/profile_serve_trace") as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            pipe(pts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    result = {
        "device": torch.cuda.get_device_name(0),
        "requests": REQUESTS,
        "stages_ms_median": stages(profiling.spans()),
        "epilogue_launches": (dense_bn_act.launches - launches) / REQUESTS,
        "profile": kernels(prof, wall_us),
    }
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
