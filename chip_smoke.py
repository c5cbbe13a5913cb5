#!/usr/bin/env python3
"""Drive the ndtpu_torch serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit on failure:

1. The card: its name and power limit (nvidia-smi). TF32 is switched off
   for every comparison.
2. The segment-moments kernel (the port of the Pallas kernel
   ``_moments_kernel``): built from ndtpu_torch/csrc at first use, held
   against its plain PyTorch version on random dense-rank inputs (slots 0
   and 29, three tag columns) and on the real sorted inputs of the
   canonical batch (taken from the port's own search-and-sort stage),
   checked bit-identical across two launches, and timed with CUDA events
   at the canonical size beside the plain version and one PyTorch
   yardstick call (``torch.segment_reduce`` over the materialised
   columns; the port never calls it).
3. Serving: a small batch on the card against the same pipeline on the
   CPU, then SegmentationPipeline(n_desired=1000, num_classes=28,
   feature_dim=768) answers 3 requests of 16 x 70000-point clouds. Each
   must give finite [16, 1000, 29] logits, every cloud converged with 1000
   NDs, and exactly one kernel launch.

It prints the per-request latency, a ``{"kernels": [...]}`` line, the card
line again, and last ``{"ok": true, "device": {...}}``. Without a card it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from ndtpu_torch.core import ndt, voxel
from ndtpu_torch.data.synthetic import example_cloud, make_batch
from ndtpu_torch.ops import _build
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.serve import SegmentationPipeline

B, N, M, C, F = 16, 70000, 1000, 28, 768
K = ndt.max_segments(M) + 1          # kernel rows: segments + the drop row
N_TAGS = 3
PEAK_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TIMED_ITERS = 20
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-4  # f32 matmuls on two devices


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def dense_rank_inputs(slots, seed):
    """Random [B, N] kernel inputs: dense sorted ranks over K - 1 segments,
    the last rows dropped (id K), masked coordinates, class tags and tag
    columns nonzero on each segment's first row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, N), np.int32)
    for b in range(B):
        pos = rng.choice(N - 1, size=K - 2, replace=False) + 1
        seg[b, pos] = 1
    seg = np.cumsum(seg, axis=1).astype(np.int32)
    seg[:, -50:] = K
    v = (rng.random((B, N)) > 0.05).astype(np.float32)
    xt, yt, zt = ((rng.uniform(-0.5, 0.5, (B, N)) * v).astype(np.float32)
                  for _ in range(3))
    cls = rng.integers(0, max(slots, 1), (B, N)).astype(np.int32)
    first = np.ones((B, N), bool)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    tags = [np.where(first, rng.integers(0, 4000, (B, N)), 0).astype(np.float32)
            for _ in range(N_TAGS)]
    t = [torch.from_numpy(a).cuda() for a in (xt, yt, zt, v, cls, seg)]
    return dict(xt=t[0], yt=t[1], zt=t[2], v=t[3], cls=t[4] if slots else None,
                seg=t[5], tags=[torch.from_numpy(a).cuda() for a in tags],
                slots=slots)


def canonical_inputs(points):
    """The kernel's inputs for the canonical batch, from the port's own
    limits, probe, search-and-sort and moment-input stages."""
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool, device=points.device)
    classes = torch.zeros(px.shape, dtype=torch.int32, device=points.device)
    mins, maxs = ndt._limits(px, py, pz, mask)
    env = ndt._min_packable_voxel_size(mins, maxs)
    seed = ndt._probe_seed_size(px, py, pz, mask, M, mins, maxs, env)
    size, _, cols = ndt._search_and_sort_fast(
        px, py, pz, mask, classes, M, mins, maxs, env, tagged=False,
        size0_override=seed,
    )
    lens, offsets = voxel.estimate_voxel_grid(mins, maxs, size)
    inp = ndt._moment_inputs(cols, size, lens, offsets, K - 1, tagged=False)
    return dict(xt=inp["xt"], yt=inp["yt"], zt=inp["zt"], v=inp["v"], cls=None,
                seg=inp["seg"], tags=list(inp["tags"]), slots=0)


def run_kernel(x):
    return sm.fused_moments_sorted(x["xt"], x["yt"], x["zt"], x["v"], x["cls"],
                                   x["seg"], K, x["slots"], tags=x["tags"])


def run_plain(x, dtype=torch.float32):
    f = [x[k].to(dtype) for k in ("xt", "yt", "zt", "v")]
    return sm.fused_moments_sorted_plain(*f, x["cls"], x["seg"], K, x["slots"],
                                         tags=[t.to(dtype) for t in x["tags"]])


def check_kernel(x, label):
    """Kernel against its plain version on the card: counts, class
    histogram and tags exact; every entry within twice the kernel's f32
    summation bound (``fused_moments_error_bound``) of the plain version
    evaluated in float64; two launches bit-identical. Returns the largest
    absolute difference from the f32 plain version."""
    a = run_kernel(x)
    b = run_kernel(x)
    ref = run_plain(x)
    ref64 = run_plain(x, torch.float64)
    bound = sm.fused_moments_error_bound(x["xt"], x["yt"], x["zt"], x["v"],
                                         x["cls"], x["seg"], K, x["slots"],
                                         tags=x["tags"])
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: two launches differ")
    if a.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
    exact = [0] + list(range(13, a.shape[-1]))
    if not torch.equal(a[..., exact], ref[..., exact]):
        raise AssertionError(f"{label}: counts/histogram/tags differ")
    excess = (a.double() - ref64).abs() - 2 * bound
    if bool((excess > 0).any()):
        raise AssertionError(f"{label}: sums off by {float(excess.max())} "
                             "beyond the f32 summation bound")
    err = float((a - ref).abs().max())
    print(f"k1 {label}: ok, max_abs_err {err:.3e}")
    return err


def time_ms(fn, iters=TIMED_ITERS):
    """Median device time of fn() in ms (CUDA events), with the 50 MB L2
    overwritten before each run, as the caller finds it after the sort."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound_ms(x):
    """Least time for the kernel's work on this card: every input byte
    read once and every output byte written once over the memory rate, or
    the f32 operations over the f32 rate, whichever is larger."""
    n_points = x["seg"].numel()
    cols_in = 5 + len(x["tags"]) + (1 if x["slots"] else 0)
    f_out = 13 + x["slots"] + len(x["tags"])
    moved = 4 * (n_points * cols_in + x["seg"].shape[0] * K * f_out)
    ops = n_points * (6 + 10 + len(x["tags"]) + x["slots"])  # products + sums
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", moved


def library_call(x):
    """torch.segment_reduce over the materialised columns: the same sums
    for ids < K (the real inputs have no dropped id)."""
    feats = sm.moment_columns(x["xt"], x["yt"], x["zt"], x["v"], x["cls"],
                              x["slots"], x["tags"])
    b = x["seg"].shape[0]
    ids = x["seg"].long() + K * torch.arange(b, device="cuda")[:, None]
    lengths = torch.bincount(ids.reshape(-1), minlength=b * K)
    data = feats.reshape(-1, feats.shape[-1])

    def call():
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)

    if not bool((x["seg"] < K).all()):
        raise AssertionError("yardstick needs ids < K")
    # same segments and layout: the integer columns (counts, tags) are
    # exact in any summation order
    exact = [0] + list(range(13, feats.shape[-1]))
    if not torch.equal(call().reshape(b, K, -1)[..., exact],
                       run_plain(x)[..., exact]):
        raise AssertionError("yardstick disagrees with the plain version")
    return call


def k1_phase():
    t0 = time.perf_counter()
    lib = _build.build(sm.SOURCE)
    print(f"k1 build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    errs = [check_kernel(dense_rank_inputs(0, 1), "random slots=0"),
            check_kernel(dense_rank_inputs(29, 2), "random slots=29")]
    points = torch.from_numpy(make_batch(B, N, seed=0)).cuda()
    real = canonical_inputs(points)
    errs.append(check_kernel(real, "canonical sorted inputs"))
    ms = time_ms(lambda: run_kernel(real))
    plain_ms = time_ms(lambda: run_plain(real))
    library_ms = time_ms(library_call(real))
    bound_ms, bound_by, moved = k1_bound_ms(real)
    print(f"k1 canonical: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"segment_reduce {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.2f} MB by {bound_by})")
    return {
        "name": "segment_moments", "route": "cuda",
        "source": "ndtpu_torch/csrc/segment_moments.cu",
        "replaces": "ndtpu/ops/pallas/segment_moments.py:190",
        "launches": None, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def small_batch_check():
    """The pipeline on the card against the same pipeline (plain versions)
    on the CPU, on a small cloud with no 2- or 3-point voxel: a
    rank-deficient covariance's singularity test is decided by rounding
    noise, so the kept NDs are comparable only without one."""
    pts = example_cloud(2, 1024, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = SegmentationPipeline(24, 8, 64, search="reference", device=dev)
        logits, mask, state = pipe(pts)
        out[dev] = (logits.cpu(), mask.cpu(), state)
    (lg, mg, sg), (lc, mc, sc) = out["cuda"], out["cpu"]
    counts = sc.counts
    if bool(((counts == 2) | (counts == 3)).any()):
        raise AssertionError("small check cloud has a 2/3-point voxel")
    for name in ("voxel_size", "num_valid", "counts", "zyx"):
        if not torch.equal(getattr(sg, name).cpu(), getattr(sc, name)):
            raise AssertionError(f"small batch: {name} differs card vs CPU")
    if not torch.equal(mg, mc):
        raise AssertionError("small batch: out_mask differs card vs CPU")
    torch.testing.assert_close(lg, lc, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    print(f"serve small batch: card == CPU (logits max diff "
          f"{float((lg - lc).abs().max()):.3e})")


def count_syncs(pipe, points):
    """Host syncs of one request, as torch's sync debug mode flags them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe(points)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def serve_phase():
    small_batch_check()
    pipe = SegmentationPipeline(n_desired=M, num_classes=C, feature_dim=F,
                                device="cuda")
    requests = [make_batch(B, N, seed=s) for s in (1, 2, 3)]
    pipe(make_batch(B, N, seed=0))  # warm-up
    torch.cuda.synchronize()
    launches = sm.fused_moments_sorted
    launches.launches = 0
    lat = []
    for i, pts in enumerate(requests):
        before = launches.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits, mask, state = pipe(pts)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = start.elapsed_time(end)
        if launches.launches - before != 1:
            raise AssertionError(f"request {i}: {launches.launches - before} "
                                 "kernel launches, expected 1")
        if tuple(logits.shape) != (B, M, C + 1):
            raise AssertionError(f"request {i}: logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"request {i}: non-finite logits")
        if not bool(state.converged.all()):
            raise AssertionError(f"request {i}: a cloud did not converge")
        if not bool((mask.sum(-1) == M).all()):
            raise AssertionError(f"request {i}: not every cloud kept {M} NDs")
        lat.append(dev_ms)
        print(f"serve request {i}: {dev_ms:.3f} ms (events), {host_ms:.3f} ms "
              f"(host), {B / dev_ms * 1e3:.1f} clouds/s, voxel sizes "
              f"{state.voxel_size.min().item():.4f}..{state.voxel_size.max().item():.4f}")
    n_launches = launches.launches
    syncs = count_syncs(pipe, requests[0])
    print(f"serve: median {statistics.median(lat):.3f} ms/request, "
          f"{B / statistics.median(lat) * 1e3:.1f} clouds/s, "
          f"{syncs} host syncs flagged per request")
    return n_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    k1 = k1_phase()
    k1["launches"] = serve_phase()
    print(json.dumps({"kernels": [k1]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
