#!/usr/bin/env python3
"""Drive the ndtpu_torch serving, giant-cloud, training, sampler, PointNet,
CARLA data, trainer-extras, data-parallel, tool, multi-device entry and
measurement-script paths, and the bf16x3 branch and A/B modes, on one
NVIDIA card and check them.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit on failure:

1. The card: its name and power limit (nvidia-smi). TF32 is switched off
   for every comparison.
2. The segment-moments kernel (K1, the port of the Pallas kernel
   ``_moments_kernel``): built from ndtpu_torch/csrc at first use, held
   against its plain PyTorch version on random dense-rank inputs (slots 0
   and 29, three tag columns) and on the real sorted inputs of the
   canonical batch (taken from the port's own search-and-sort stage),
   checked bit-identical across two launches, and timed with CUDA events
   at the canonical size beside the plain version, one PyTorch
   yardstick call (``torch.segment_reduce`` over the materialised
   columns; the port never calls it) and a read floor (``torch.sum``
   over as many bytes as the bound counts, under the same L2 flush).
3. Serving: a small batch on the card against the same pipeline on the
   CPU, then SegmentationPipeline(n_desired=1000, num_classes=28,
   feature_dim=768) answers 3 requests of 16 x 70000-point clouds. Each
   must give finite [16, 1000, 29] logits, every cloud converged with 1000
   NDs, and exactly one K1 launch.
4. The giant cloud (bench.py --giant): one 1,048,576-point cloud to 2080
   NDs through make_point_sharded_downsample(search="probe") on a one-rank
   NCCL group. K1 is held against its plain version on the moment pass's
   real inputs (B = 1, slots = 1, two tag columns) and timed there. The
   tags kernel (K3,
   ``_tags_kernel``) and the segment sum kernel (K2, ``_kernel``) are held
   against their plain versions on random inputs and on the cloud's real
   sorted inputs, and timed like K1. K2 is also checked and timed at the
   canonical batch's real sorted ids with 28 class slots ([16, 70000, 41]
   -> [16, 1209, 41], the JAX ``segment_moments(num_class_slots=28,
   use_pallas=True)`` route on that batch).
   Then 5 timed downsamples, each converged, in band, 2080 NDs, finite,
   with one K1 launch, one K3 launch per search evaluation plus one, and
   the collectives of the JAX structure; the sharded moments against the
   single-device segment_moments (K2) on the same sorted cloud; the
   accepted size against the single-device fast search; a stage split;
   and the second-stage ndt_prune to 1040.
5. Training (bench.py --train, tools/train.py): K1 held against its plain
   version and timed on the training batch's real tagged inputs (M 2080,
   29 class slots: [16, 70000] -> [16, 2504, 45]); one train step of the
   same weights on the card and on the CPU; the trainer CLI in this
   process at TrainConfig's full width (B 16, N 70000, M 2080, 28
   classes, feature_dim 768, probe, int labels): an epoch of 2 steps, val
   and test evals and a checkpoint, then an epoch resumed from it (steps
   2 -> 4), every loss finite and every cloud converged with 2080 NDs;
   then 5 timed steps on bench.py's batch with one K1 launch each, the
   host syncs of a step (only the preprocessing's), a stage split and the
   device share.
6. Classification (tools/train.py --task classification): one step of the
   same weights on the card and on the CPU; the trainer CLI at full width
   (B 16, N 70000, M 1000, 40 classes, feature_dim 768, SyntheticCls): an
   epoch of 2 steps with val and test evals and a checkpoint, then an
   epoch resumed from it; 5 timed steps with one K1 launch each (untagged,
   [16, 70000] -> K 1208), the host syncs of a step (only the
   preprocessing's), a stage split and peak memory.
7. NDT-Net++ (bench.py --multiscale, tools/train_multiscale.py): K1 held
   against its plain version and timed on the fine batch's real tagged
   inputs ([4, 70000] -> [4, 9800, 45], 29 class slots); 3 timed forward
   requests (B 4, N 70000, fine 8160 and coarse 4080 NDs, 28 classes,
   feature_dim 1024; two K1 launches each); one multiscale step card vs
   CPU; 5 timed full-width train steps (two K1 launches each) with the
   host syncs, a stage split (fine prep, coarse prep, forward, loss +
   backward, optimizer) and peak memory; the multiscale trainer CLI at
   its full width for an epoch of 8 steps and 8 val evals.
8. The sampler's variants on the serving batch (seed 1) with its last
   cloud replaced by an outlier cloud (a 1 m cube of points and one point
   4 km away): K1 held against its plain version on the pair-key build;
   probe/packed (the serving path), grid/packed, grid/pair, probe/pair
   and probe/packed with the legacy_c prune, each a warm-up and 3 timed
   downsamples with one K1 launch each, every ordinary cloud converged
   with 1000 NDs, the outlier cloud converged under pair keys and
   reported unconverged under packed ones, the host syncs of one, and two
   clouds against the CPU at the card's accepted sizes; ndt_prune to 500
   in the legacy_c order, checked against the CPU and timed.
9. PointNet (tools/train_pointnet.py): one step card vs CPU (no K1
   launch); 5 timed steps at full width (B 16, N 4160, 28 classes,
   feature_dim 768) with the split forward / loss + backward / optimizer,
   the host syncs (none) and peak memory; the PointNet trainer CLI for an
   epoch and a resumed one on a CarlaSeg tree of 16 PLY clouds it writes
   under build/.
10. CARLA data: 8 PLY clouds of 70000 points and 29 class tags written
   under build/; read_ply native and numpy, timed and bitwise equal; FPS
   on the card equal to the CPU on an exact-arithmetic cloud (20000 ->
   4160 points); CarlaNDTSeg
   (FPS 70000 -> 4160 points on the card, a tagged reference downsample
   to 2080 NDs) on 3 items, one K1 launch each, FPS ms a cloud, its
   device share and the host syncs an item; the segmentation trainer CLI for an epoch with
   --train_path/--val_path/--test_path on the tree (batch 8, three K1
   launches).
11. Trainer extras (tools/train.py --device_cache --epoch_scan, bf16):
   a DeviceCachedDataset of SyntheticSeg (32 clouds of 70000 points a
   split) and the full-width segmentation state; one epoch of 2 steps per
   step and one as a CUDA graph of the step (make_epoch_scan) with the
   same order from the same weights, compared; the eval graph on the val
   split; a graph epoch replayed under sync debug mode "error" (no host
   sync), K1 once a replay (profiler) and held against its plain version
   on the graph path's inputs; the graph step timed beside the eager step;
   the sync-free preprocessing (fixed rounds) against the eager one (bit
   for bit, timed); the --streaming and classification graphs; peak
   memory; a bf16 step card vs CPU; 5 timed full-width bf16 steps of the
   segmentation, classification, multiscale and PointNet steps; 3 bf16
   serving requests; the eager step's optimizer stage with plain and
   capturable Adam; the trainer CLI with --device_cache --compute_dtype
   bfloat16 for an epoch and a resumed one (steps 2 -> 4). K1's launches
   here are its wrapper's count (eager launches; it counts a call
   captured into a graph apart, in ``captured``) plus one for each replay
   of a graph that captured one K1 call; K1 is held against its plain
   version after the counts are read.
12. Data parallelism (the trainers' --num_processes): the segmentation,
   multiscale and PointNet steps at full width from one state on one
   batch, in float64 without a group, and on a one-rank NCCL data group in
   float64 and in float32 (compute and parameters; one K1 launch a
   resolution each): the float64 DP step held to the float64 step within
   1e-9 of each gradient leaf's largest, the float32 DP step to it
   within its model's limit, the float32 step's collectives counted
   (all-reduces only, bytes within [param_bytes, 1.15 param_bytes +
   4096]); 5 timed segmentation steps without a group beside 5 timed DP
   steps, each with its stage split and kernel count; the DP graph epoch
   on a sharded DeviceCachedDataset of 32 SyntheticSeg clouds,
   bit-identical to the per-step DP epoch, no host sync in a replay, K1
   once a replay, timed; 3 timed multiscale and PointNet DP steps; two
   worker processes of this script (``--dp_worker``) as two gloo ranks on
   the one card (NCCL takes one rank a card), 2 steps at lr 0 and 2 at lr
   1e-3 in float64 against one process on the whole batch.

13. The tools (python -m ndtpu_torch.tools.*) at full width: the frame
   stream (tools/stream.py: 16 frames of 70000 points -> 1000 NDs, probe
   search, a full search every 8 frames, a seed-0 checkpoint of the
   28-class segmentation model at feature_dim 768 colouring each frame)
   in warm and in fixed mode, one K1 launch a frame, the steady ms a
   frame, the band, the host syncs of a steady frame; the same stream
   card == CPU at 4 x 8192 points; viz (90000 points -> 2080 NDs, 29
   slots, reference search, pruned to 1000, a torch.profiler trace);
   seg_viz (70000 -> 2080 NDs); export of the checkpoint, reloaded through
   torch_weights, logits bit-identical on one request; the
   hyperparameter search (2 trials x 1 epoch at its defaults). K1 is
   held against its plain version on every shape these paths gave it.
14. The multi-device entry (serve.dryrun_multichip): one rank on
   a one-rank NCCL group in this process (B 2 x N 128 -> M 12, 4
   classes, feature_dim 32): the DP segmentation step held to the
   single-process step, in float64 within the JAX bound and in float32
   within the bound or the rounding band the entry measures, the
   NDT-Net++ step, cloud 0's point-sharded moments at voxel size 1.0
   (counts sum to 128); the JAX entry's line; 11 K1 and 1 K3 launches,
   each held against its plain version on the path's shapes. With more than one card, also
   dryrun_multichip(device_count); with one, NCCL across cards is
   unmeasured.
15. The measurement scripts (python -m ndtpu_torch.scripts.*), each main
   once, each JSON line printed: stage_timing at the canonical batch (16
   x 70000 -> 1000, 29 slots), M 2080 and the giant cloud (one NCCL
   rank); seed_hit_rate and probe_seed_validate on 4 clouds a
   distribution, card == CPU; collectives at one NCCL rank (66
   all-reduces, 1.0069 x the parameter bytes, as the dp phase's step);
   model_timing with flat and fold in f32 and bf16; every kernel_micro
   mode (K2, K1 and its cost probes P1 and P2 launched 97 times each by
   their modes and by no other); the five prep_micro modes. K1 and K3
   are held against their plain versions on every shape these paths gave
   them, K2 on the pallas mode's ([16, 70000, 42], dense ranks over
   1209). Then K1's cost split at that shape (3 tag columns) at 0, 1 and
   29 class slots: P1 (``moments_empty``, the launch of K1's plan whose
   body only zeroes the output) all zero, P2 (``moments_noflop``, K1's
   streaming and row build) within its f32 summation bound of its plain
   version, K1 within its bound, the three timed in turns, and the
   figures empty, noflop - empty and moments - noflop printed beside K1's
   bound and read floor.
16. The bf16x3 branch (NDTPU_PALLAS_PRECISION=bf16x3) and the sampler's
   A/B modes. K1's tensor-core kernel (``fused_moments_sorted_bf16x3``)
   on the inputs K1 was timed at (the canonical batch, the giant moment
   pass, the training batch and the multiscale fine batch, 29 slots
   there) and K2's (``segment_sum_sorted_bf16x3``) at the giant oracle,
   the canonical batch F 41 and the pallas mode's [16, 70000, 42]: two
   launches bit-identical, within the branch's bound of the float64 sums,
   K1's count, class and sparse tag columns equal to the bf16x3 plain
   version, within both kernels' bounds of the f32 kernel's output, timed
   in turns with the f32 kernel. Then, with the bf16x3 counts zeroed
   just before, serving requests (16 x 70000 -> 1000, 28 classes,
   feature_dim 768, probe) and eager segmentation train steps (the
   training batch) under bf16x3, each in turns with the same under f32:
   converged, the asked counts, finite, the state's integers equal to
   f32's, means and covariances and the well-posed KLs within the stated
   tolerances, the kept NDs within KEPT_DIFF_FRAC of f32's; and
   kernel_micro's pallas mode (K2) under bf16x3. Last, one serving request
   under each of NDTPU_EMIT=payload, NDTPU_KL_MODE=gather and
   NDTPU_KL_MODE=gather NDTPU_KL_INV=argsort: bit-identical to the
   default request, timed in turns with it. The variables are set and
   restored around each call (``environ``).

It prints the timings, a ``{"kernels": [...]}`` line, the card line again,
and last ``{"ok": true, "device": {...}}``. Without a card it exits
non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from ndtpu_torch.core import moments, ndt, voxel
from ndtpu_torch.core.kl import INT32_MAX, neighbor_min_kl
from ndtpu_torch.data.carla import CarlaNDTSeg
from ndtpu_torch.data.ply import read_ply, write_ply
from ndtpu_torch.data.synthetic import (
    SyntheticCls,
    SyntheticSeg,
    example_cloud,
    giant_cloud,
    make_batch,
)
from ndtpu_torch.models import (
    NDTNetClassification,
    NDTNetPPSegmentation,
    NDTNetSegmentation,
    PointNetSegmentation,
)
from ndtpu_torch.ops import _build
from ndtpu_torch.ops import moment_probes as mp
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.ops.fps import farthest_point_sampling
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel.collectives import Collectives
from ndtpu_torch.parallel import point_sharded as ps
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.scripts import (
    collectives as collectives_script,
    kernel_micro,
    model_timing,
    prep_micro,
    probe_seed_validate,
    seed_hit_rate,
    stage_timing,
)
from ndtpu_torch.serve import (JITTERS, SegmentationPipeline, dryrun_multichip,
                               init_random_)
from ndtpu_torch.interop.torch_weights import map_ndtnet_segmentation
from ndtpu_torch.tools import export as export_cli
from ndtpu_torch.tools import hyperparameter_search as hps_cli
from ndtpu_torch.tools import seg_viz as seg_viz_cli
from ndtpu_torch.tools import stream as stream_cli
from ndtpu_torch.tools import train as train_cli
from ndtpu_torch.tools import viz as viz_cli
from ndtpu_torch.tools import train_multiscale as train_multiscale_cli
from ndtpu_torch.tools import train_pointnet as train_pointnet_cli
from ndtpu_torch.train import loop as train_loop
from ndtpu_torch.train.loop import (
    make_classification_step,
    make_multiscale_seg_step,
    make_ndt_seg_step,
    make_pointnet_seg_step,
)
from ndtpu_torch.train import state as train_state
from ndtpu_torch.train.loop import make_lr_schedule
from ndtpu_torch.train.state import create_train_state, make_capturable
from ndtpu_torch.core.ndt import _fixed_rounds
from ndtpu_torch.data.loader import (
    CachedDataset,
    DeviceCachedDataset,
    batch_iterator,
    prefetch_to_device,
    sharded_batch,
)
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.loop import make_epoch_scan, run_epoch_scan

B, N, M, C, F = 16, 70000, 1000, 28, 768
K = ndt.max_segments(M)              # kernel rows: k_max (ids >= K dropped)
N_TAGS = 3
PEAK_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TIMED_ITERS = 20
PAD_CYCLES = 1_000_000               # ~0.5 ms spin before each timed run
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-4  # f32 matmuls on two devices

GIANT_N, GIANT_M = 1_048_576, 2080   # bench.py --giant
GIANT_K = ndt.max_segments(GIANT_M)  # k_max = 2504 table rows
GIANT_RUNS = 5
PAIR_TAGS = 4                        # 12-bit splits of the (zy, x) keys
KERNELS = (sm.fused_moments_sorted, sm.segment_tags_sorted,
           sm.segment_sum_sorted)


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
                slots=slots, k=K)


def canonical_inputs(points, m=M, labels=None, key_mode="packed"):
    """The kernel's inputs for a batch reduced to m NDs, from the port's
    own limits, probe, search-and-sort and moment-input stages at the
    envelope of ``key_mode``: untagged, or tagged with int labels [B, N]
    in C + 1 class slots (the training path)."""
    px, py, pz = (points[..., a].contiguous() for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool, device=points.device)
    tagged = labels is not None
    classes = (labels.to(torch.int32) if tagged else
               torch.zeros(px.shape, dtype=torch.int32, device=points.device))
    k = ndt.max_segments(m)
    mins, maxs = ndt._limits(px, py, pz, mask)
    env = ndt._envelope(mins, maxs, key_mode)
    seed = ndt._probe_seed_size(px, py, pz, mask, m, mins, maxs, env)
    size, _, cols = ndt._search_and_sort_fast(
        px, py, pz, mask, classes, m, mins, maxs, env, tagged=tagged,
        size0_override=seed,
    )
    lens, offsets = voxel.estimate_voxel_grid(mins, maxs, size)
    inp = ndt._moment_inputs(cols, size, lens, offsets, k, tagged=tagged)
    return dict(xt=inp["xt"], yt=inp["yt"], zt=inp["zt"], v=inp["v"],
                cls=inp["cls"], seg=inp["seg"], tags=list(inp["tags"]),
                slots=C + 1 if tagged else 0, k=k)


def run_kernel(x):
    return sm.fused_moments_sorted(x["xt"], x["yt"], x["zt"], x["v"], x["cls"],
                                   x["seg"], x["k"], x["slots"], tags=x["tags"])


def run_plain(x, dtype=torch.float32):
    f = [x[k].to(dtype) for k in ("xt", "yt", "zt", "v")]
    return sm.fused_moments_sorted_plain(*f, x["cls"], x["seg"], x["k"],
                                         x["slots"],
                                         tags=[t.to(dtype) for t in x["tags"]])


def k1_error_bound(x):
    return sm.fused_moments_error_bound(x["xt"], x["yt"], x["zt"], x["v"],
                                        x["cls"], x["seg"], x["k"], x["slots"],
                                        tags=x["tags"])


def sparse_tag_columns(x):
    """The output columns of x's tags that hold at most one nonzero a
    segment (as the pipeline makes them): their sums are exact."""
    if not x["tags"]:
        return []
    nonzero = torch.stack([t != 0 for t in x["tags"]], -1).float()
    most = sm.segment_sum_sorted_plain(nonzero, x["seg"], x["k"])
    most = most.reshape(-1, len(x["tags"])).amax(0)
    return [13 + x["slots"] + t for t in range(len(x["tags"]))
            if float(most[t]) <= 1]


def check_kernel(x, label):
    """Kernel against its plain version on the card: counts, class
    histogram and the sparse tag columns exact (``sparse_tag_columns``);
    every entry within twice the kernel's f32 summation bound
    (``fused_moments_error_bound``) of the plain version evaluated in
    float64; two launches bit-identical. Returns the largest absolute
    difference from the f32 plain version."""
    a = run_kernel(x)
    b = run_kernel(x)
    ref = run_plain(x)
    ref64 = run_plain(x, torch.float64)
    bound = k1_error_bound(x)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: two launches differ")
    if a.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(a.shape)} != {tuple(ref.shape)}")
    sparse = sparse_tag_columns(x)
    exact = [0] + list(range(13, 13 + x["slots"])) + sparse
    if not torch.equal(a[..., exact], ref[..., exact]):
        raise AssertionError(f"{label}: counts/histogram/tags differ")
    excess = (a.double() - ref64).abs() - 2 * bound
    if bool((excess > 0).any()):
        raise AssertionError(f"{label}: sums off by {float(excess.max())} "
                             "beyond the f32 summation bound")
    err = float((a - ref).abs().max())
    print(f"k1 {label}: ok, max_abs_err {err:.3e}, tags exact "
          f"{len(sparse)}/{len(x['tags'])}")
    return err


def times_ms(fns, iters=TIMED_ITERS, clean=False):
    """Median device ms of each of ``fns`` (name -> function) between two
    CUDA events, after 3 untimed calls each; the functions timed in turns
    (forward, then backward order). Before each run the 50 MB L2 is
    overwritten, as the caller finds it after the sort: by writing 256 MB
    (the L2 left dirty), or with ``clean`` by reading them; then a spin of
    PAD_CYCLES keeps the card busy while the host enqueues the timed call,
    so the events time the card's work and not a wrapper's host time (a
    kernel's wrapper can take the host longer than the flush takes the
    card)."""
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(iters):
        for name in (order if i % 2 == 0 else order[::-1]):
            if clean:
                flush.sum()
            else:
                flush.zero_()
            torch.cuda._sleep(PAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def time_ms(fn, iters=TIMED_ITERS, clean=False):
    """times_ms of fn alone."""
    return times_ms({"fn": fn}, iters, clean)["fn"]


def read_floor_ms(nbytes):
    """time_ms of torch.sum over a contiguous f32 buffer of nbytes: one
    launch that only reads a kernel's bytes, under the same L2 flush (the
    flush leaves the L2 dirty, so a cold read here runs well below the
    card's 3.35 TB/s)."""
    buf = torch.ones(max(1, nbytes // 4), dtype=torch.float32, device="cuda")
    return time_ms(buf.sum)


def bound(n_points, bytes_per_point, out_bytes, ops):
    """Least time for a kernel's work on this card: every input byte read
    once and every output byte written once over the memory rate, or the
    f32 operations over the f32 rate, whichever is larger. Returns (ms,
    "bytes" or "operations", bytes)."""
    moved = n_points * bytes_per_point + out_bytes
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", moved


def k1_bound_ms(x):
    """K1's bound: seg, xt, yt, zt, v (+ cls, + tags) per kept point (id <
    K; the kernel reads no dropped point), the [B, K, 13 + slots + T] rows,
    16 + T + slots products and sums a point."""
    n_points = int((x["seg"] < x["k"]).sum())
    batch = x["seg"].numel() // x["seg"].shape[-1]
    cols_in = sm.staged_columns(x["slots"], len(x["tags"]))
    f_out = 13 + x["slots"] + len(x["tags"])
    return bound(n_points, 4 * cols_in, 4 * batch * x["k"] * f_out,
                 n_points * (6 + 10 + len(x["tags"]) + x["slots"]))


def library_call(x):
    """torch.segment_reduce over the materialised columns: the same sums
    for ids < K (the real inputs have no dropped id)."""
    feats = sm.moment_columns(x["xt"], x["yt"], x["zt"], x["v"], x["cls"],
                              x["slots"], x["tags"])
    k = x["k"]
    seg = x["seg"].reshape(-1, x["seg"].shape[-1])
    b = seg.shape[0]
    ids = seg.long() + k * torch.arange(b, device="cuda")[:, None]
    lengths = torch.bincount(ids.reshape(-1), minlength=b * k)
    data = feats.reshape(-1, feats.shape[-1])

    def call():
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)

    if not bool((seg < k).all()):
        raise AssertionError("yardstick needs ids < K")
    # same segments and layout: the integer columns (counts, tags) are
    # exact in any summation order
    exact = [0] + list(range(13, feats.shape[-1]))
    if not torch.equal(call().reshape(b, k, -1)[..., exact],
                       run_plain(x).reshape(b, k, -1)[..., exact]):
        raise AssertionError("yardstick disagrees with the plain version")
    return call


# the inputs each kernel was timed at, by (kernel, label): the bf16x3
# phase times the branch on them
TIMED = {}


def k1_times(x, label):
    """K1's time at x beside its plain version, the segment_reduce
    yardstick and its bound: the timing keys of a kernels-line entry."""
    TIMED["k1", label] = x
    ms = time_ms(lambda: run_kernel(x))
    plain_ms = time_ms(lambda: run_plain(x))
    library_ms = time_ms(library_call(x))
    bound_ms, bound_by, moved = k1_bound_ms(x)
    floor_ms = read_floor_ms(moved)
    print(f"k1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"segment_reduce {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.2f} MB by {bound_by}), read floor {floor_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "read_floor_ms": floor_ms}


def k1_phase():
    """Build the kernels, check K1 on random and canonical inputs, time it
    at the canonical batch. Returns its kernels-line entry without
    launches, and the canonical batch's real inputs."""
    t0 = time.perf_counter()
    lib = _build.build(sm.SOURCE)
    print(f"k1 build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    errs = [check_kernel(dense_rank_inputs(0, 1), "random slots=0"),
            check_kernel(dense_rank_inputs(29, 2), "random slots=29")]
    points = torch.from_numpy(make_batch(B, N, seed=0)).cuda()
    real = canonical_inputs(points)
    errs.append(check_kernel(real, "canonical sorted inputs"))
    return {
        "name": "segment_moments", "route": "cuda",
        "source": "ndtpu_torch/csrc/segment_moments.cu",
        "replaces": "ndtpu/ops/pallas/segment_moments.py:190",
        "max_abs_err": max(errs), **k1_times(real, "canonical"),
    }, real


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


def count_syncs(fn):
    """Host syncs of fn(), as torch's sync debug mode flags them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
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
    for kernel in KERNELS:
        kernel.launches = 0
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
    syncs = count_syncs(lambda: pipe(requests[0]))
    print(f"serve: median {statistics.median(lat):.3f} ms/request, "
          f"{B / statistics.median(lat) * 1e3:.1f} clouds/s, "
          f"{syncs} host syncs flagged per request")
    return n_launches


# ---- the giant cloud ----

def random_ranks(rng, dropped):
    """[GIANT_N] dense sorted ranks over GIANT_K - 1 segments, the last
    ``dropped`` rows given the dropped id GIANT_K."""
    seg = np.zeros(GIANT_N, np.int32)
    seg[rng.choice(GIANT_N - 1, size=GIANT_K - 2, replace=False) + 1] = 1
    seg = np.cumsum(seg).astype(np.int32)
    seg[GIANT_N - dropped:] = GIANT_K
    return seg


def sparse_tags(seg, n_tags, rng):
    """Columns nonzero (< 2**12) only on each segment's first row."""
    first = np.ones(seg.shape, bool)
    first[1:] = seg[1:] != seg[:-1]
    return [torch.from_numpy(np.where(first, rng.integers(0, 1 << 12, seg.shape),
                                      0).astype(np.float32)).cuda()
            for _ in range(n_tags)]


def check_tags(seg, tags, label, k=GIANT_K):
    """K3 against its plain version on the card: exact (each kept segment
    holds one nonzero per column), and two launches bit-identical."""
    a = sm.segment_tags_sorted(seg, tags, k)
    b = sm.segment_tags_sorted(seg, tags, k)
    ref = sm.segment_tags_sorted_plain(seg, tags, k)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"k3 {label}: two launches differ")
    if not torch.equal(a, ref):
        raise AssertionError(f"k3 {label}: differs from the plain version "
                             f"by {float((a - ref).abs().max())}")
    print(f"k3 {label}: ok, exact")
    return 0.0


def check_sum(feats, seg, label, k=GIANT_K):
    """K2 against its plain version on the card: every entry within twice
    the kernel's f32 summation bound (``segment_sum_error_bound``) of the
    plain version in float64, two launches bit-identical. Returns the
    largest difference from the f32 plain version."""
    a = sm.segment_sum_sorted(feats, seg, k)
    b = sm.segment_sum_sorted(feats, seg, k)
    ref = sm.segment_sum_sorted_plain(feats, seg, k)
    ref64 = sm.segment_sum_sorted_plain(feats.double(), seg, k)
    tol = 2 * sm.segment_sum_error_bound(feats, seg, k)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"k2 {label}: two launches differ")
    if a.shape != ref.shape:
        raise AssertionError(f"k2 {label}: shape {tuple(a.shape)}")
    excess = (a.double() - ref64).abs() - tol
    if bool((excess > 0).any()):
        raise AssertionError(f"k2 {label}: off by {float(excess.max())} "
                             "beyond the f32 summation bound")
    err = float((a - ref).abs().max())
    print(f"k2 {label}: ok, max_abs_err {err:.3e}")
    return err


def sorted_cloud(points, state):
    """The cloud sorted by packed voxel key at the state's grid, as the
    single-device oracle of tests/test_sharding.py builds it: sorted
    points, their voxel centres, dense segment ranks (GIANT_K beyond the
    table), and the (z, y, x) table padded with INT32_MAX."""
    size, lens, offsets = state.voxel_size, state.lens[0], state.offsets[0]
    coords, _ = voxel.metric_to_voxel_space(points, size, lens, offsets)
    key, order = torch.sort(voxel.voxel_pos_to_index(coords, lens), stable=True)
    coords = coords[order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    seg = torch.clamp(torch.cumsum(new, 0) - 1, max=GIANT_K).to(torch.int32)
    table = torch.full((GIANT_K, 3), INT32_MAX, dtype=torch.int32,
                       device=points.device)
    starts = coords[new].flip(-1)[:GIANT_K]
    table[:starts.shape[0]] = starts
    return (points[order], voxel.voxel_to_metric_space(coords, size, offsets),
            seg, table)


def segment_reduce_call(data, seg, k):
    """torch.segment_reduce over the [..., N, F] rows of ids < k, every
    cloud's k segments in turn: the yardstick of K2 and K3. The kept rows
    are gathered here, outside the timed call."""
    seg = seg.reshape(-1, seg.shape[-1])
    keep = seg < k
    ids = seg.long() + k * torch.arange(seg.shape[0], device=seg.device)[:, None]
    lengths = torch.bincount(ids[keep], minlength=seg.shape[0] * k)
    rows = data.reshape(-1, data.shape[-1])[keep.reshape(-1)]
    return lambda: torch.segment_reduce(rows, "sum", lengths=lengths, axis=0)


def reduce_times(name, label, call, plain, data, seg, k):
    """The timing keys of K2 or K3 at one input: the kernel, its plain
    version, the segment_reduce yardstick, the bound and the read floor.
    The bound counts per kept point its F f32 columns and per row of the
    [..., k, F] output its F floats, one add per column: the kernel also
    reads every kept point's id (4 B a point, not counted) for its run
    starts."""
    TIMED[name, label] = (data, seg, k)
    lib = segment_reduce_call(data, seg, k)
    width = data.shape[-1]
    if not torch.equal(lib()[:, 0], plain().reshape(-1, width)[:, 0]):
        raise AssertionError(f"{name}: yardstick disagrees with the plain version")
    kept = int((seg < k).sum())
    clouds = seg.numel() // seg.shape[-1]
    bound_ms, bound_by, moved = bound(kept, 4 * width, 4 * clouds * k * width,
                                      kept * width)
    ms, plain_ms, library_ms = time_ms(call), time_ms(plain), time_ms(lib)
    floor_ms = read_floor_ms(moved)
    print(f"{name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"segment_reduce {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.2f} MB by {bound_by}; ids {4 * kept / 1e6:.2f} MB "
          f"more), read floor {floor_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "read_floor_ms": floor_ms}


def batch_sum_inputs(real, slots=C):
    """K2's input at the canonical batch: the real sorted ids and the
    [B, N, 13 + slots] moment columns with classes drawn from a seed (the
    JAX segment_moments(num_class_slots=slots, use_pallas=True) route)."""
    cls = torch.from_numpy(np.random.default_rng(11).integers(
        0, slots, tuple(real["seg"].shape)).astype(np.int32)).cuda()
    feats = sm.moment_columns(real["xt"], real["yt"], real["zt"], real["v"],
                              cls, slots).contiguous()
    return feats, real["seg"], real["k"]


def k2_batch(real):
    """K2 checked and timed at the canonical batch ([16, 70000, 41]):
    its max_abs_err and timing keys there."""
    feats, seg, k = batch_sum_inputs(real)
    err = check_sum(feats, seg, "canonical batch, 28 slots", k)
    times = reduce_times("segment_sum_sorted", "canonical batch F=41",
                         lambda: sm.segment_sum_sorted(feats, seg, k),
                         lambda: sm.segment_sum_sorted_plain(feats, seg, k),
                         feats, seg, k)
    return {"max_abs_err": err, **times}


def giant_k1_inputs(points, state):
    """K1's inputs in the moment pass at the state's grid (one rank:
    B = 1, slots = 1, the two 12-bit tag columns of the voxel keys)."""
    mask = torch.ones(GIANT_N, dtype=torch.bool, device="cuda")
    cls = torch.zeros(GIANT_N, dtype=torch.int32, device="cuda")
    x = ps._moment_inputs(points, mask, state.voxel_size, state.lens[0],
                          state.offsets[0], GIANT_K, cls)
    return dict(x, tags=list(x["tags"]), slots=1, k=GIANT_K)


def giant_pair_inputs(points, state):
    """K3's real inputs: the sorted (zy, x) pair keys at the accepted size,
    as the search's last count builds them: (ids, 4 tag columns)."""
    mask = torch.ones(GIANT_N, dtype=torch.bool, device="cuda")
    cols = ps._sorted_pair_cols(points, mask, state.voxel_size, state.lens[0],
                                state.offsets[0])
    tseg, tags, _ = ps._table_inputs(cols, GIANT_K)
    return tseg, tags


def giant_oracle_inputs(points, state):
    """K2's real inputs in the giant oracle: the [N, 14] moment columns of
    the sorted cloud and its dense ranks."""
    pts, centres, mseg, _ = sorted_cloud(points, state)
    cls = torch.zeros(GIANT_N, dtype=torch.int32, device="cuda")
    feats = moments.moment_features(pts, centres, classes=cls,
                                    num_class_slots=1)
    return feats, mseg


def giant_kernels(points, state):
    """Hold K1 against its plain version on the moment pass's real inputs
    and time it there; build K3 and K2, hold them against their plain
    versions on random and on the giant cloud's real inputs, time them at
    the real shapes. Returns (K1's max_abs_err here, K1's timing keys
    there, [K3 entry, K2 entry] without launches)."""
    k1_x = giant_k1_inputs(points, state)
    k1_err = check_kernel(k1_x, "giant moment pass (B=1, slots=1, T=2)")
    k1_giant = k1_times(k1_x, "giant moment pass")
    rng = np.random.default_rng(7)
    seg = torch.from_numpy(random_ranks(rng, 5000)).cuda()
    k3_err = check_tags(seg, sparse_tags(seg.cpu().numpy(), PAIR_TAGS, rng),
                        "random, 5000 dropped")
    k2_err = max(check_sum(torch.from_numpy(rng.normal(size=(GIANT_N, f)).astype(
        np.float32)).cuda(), seg, f"random F={f}") for f in (14, 42))

    tseg, tags = giant_pair_inputs(points, state)
    k3_err = max(k3_err, check_tags(tseg, tags, "giant pair keys"))
    feats, mseg = giant_oracle_inputs(points, state)
    k2_err = max(k2_err, check_sum(feats, mseg, "giant moment columns"))

    out = []
    for name, line, err, call, plain, data, seg_ in (
        ("segment_tags_sorted", 403, k3_err,
         lambda: sm.segment_tags_sorted(tseg, tags, GIANT_K),
         lambda: sm.segment_tags_sorted_plain(tseg, tags, GIANT_K),
         torch.stack(tags, -1), tseg),
        ("segment_sum_sorted", 56, k2_err,
         lambda: sm.segment_sum_sorted(feats, mseg, GIANT_K),
         lambda: sm.segment_sum_sorted_plain(feats, mseg, GIANT_K),
         feats, mseg),
    ):
        out.append({
            "name": name, "route": "cuda",
            "source": "ndtpu_torch/csrc/segment_moments.cu",
            "replaces": f"ndtpu/ops/pallas/segment_moments.py:{line}",
            "max_abs_err": err,
            **reduce_times(name, "giant", call, plain, data, seg_, GIANT_K),
        })
    return k1_err, k1_giant, out


def check_giant(out, label):
    pcl, covs, labels, out_mask, state = out
    if not bool(state.converged.all()):
        raise AssertionError(f"{label}: not converged")
    nv = int(state.num_valid[0])
    if not GIANT_M <= nv <= int(GIANT_M * (1 + ndt.DOWNSAMPLE_UPPER_THRESHOLD)):
        raise AssertionError(f"{label}: num_valid {nv} out of band")
    if int(out_mask.sum()) != GIANT_M:
        raise AssertionError(f"{label}: {int(out_mask.sum())} NDs kept")
    if tuple(pcl.shape) != (GIANT_M, 3) or tuple(covs.shape) != (GIANT_M, 9):
        raise AssertionError(f"{label}: shapes {tuple(pcl.shape)} {tuple(covs.shape)}")
    if not (bool(torch.isfinite(pcl).all()) and bool(torch.isfinite(covs).all())):
        raise AssertionError(f"{label}: non-finite outputs")
    return nv


def check_collectives(calls, k3, label):
    """The JAX structure (tests/test_collectives.py): one [2, k_max] table
    all-gather per search evaluation; in the moment pass one [k_max]
    all-gather and one [k_max, 14] all-reduce; the [1, 6] limits reduce.
    One K3 launch per evaluation plus the merge. Returns the evaluations."""
    evals = calls["all_gather", (2, GIANT_K)]
    want = collections.Counter({("all_gather", (2, GIANT_K)): evals,
                                ("all_gather", (GIANT_K,)): 1,
                                ("all_reduce", (1, 6)): 1,
                                ("all_reduce", (GIANT_K, 14)): 1})
    if evals < 1 or calls != want:
        raise AssertionError(f"{label}: collectives {dict(calls)}")
    if k3 != evals + 1:
        raise AssertionError(f"{label}: {k3} K3 launches, {evals} evaluations")
    return evals


def giant_stages(points, group):
    """The downsample's steps with a CUDA event between them (a stage
    includes any wait of the card for the host)."""
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    torch.cuda.synchronize()
    mark("start")
    mask = torch.ones(GIANT_N, dtype=torch.bool, device="cuda")
    classes = torch.zeros(GIANT_N, dtype=torch.int32, device="cuda")
    mins, maxs = ps.global_limits(points, mask, group)
    mark("limits")
    size, conv = ps.search_voxel_size(group, points, mask, mins, maxs, GIANT_M,
                                      GIANT_K, "probe")
    mark("search")
    size, conv, lens, offsets = ps.accepted_grid(size, conv, mins, maxs)
    mom = ps.sharded_segment_moments(group, points, mask, size, lens[0],
                                     offsets[0], GIANT_K, 1, classes)
    mark("moment pass")
    state = ps.state_from_moments(mom, size, lens, offsets, conv)
    mark("finalise + KL")
    ndt._emit(state, GIANT_M)
    mark("emit")
    torch.cuda.synchronize()
    return {name: marks[i][1].elapsed_time(e)
            for i, (name, e) in enumerate(marks[1:])}


def device_share(fn):
    """torch.profiler over one fn(): (kernels and copies, device busy ms,
    wall ms, the 5 kernel names with the most device time and their
    ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    n = 0
    for e in prof.events():
        # kernels and copies; a user annotation's range on the card (e.g.
        # the optimizer's step) spans kernels counted already
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n += 1
    top = [(k, v / 1e3) for k, v in by_name.most_common(5)]
    return n, sum(by_name.values()) / 1e3, wall_us / 1e3, top


def giant_phase():
    """Returns (K1 launches, K1's max_abs_err and timing keys at the giant
    shape, [K3 entry, K2 entry] with their launches) of the giant path."""
    t0 = time.perf_counter()
    points = torch.from_numpy(giant_cloud(GIANT_N, seed=0)).cuda()
    group = mesh.make_group("cuda")
    try:
        fn = ps.make_point_sharded_downsample(GIANT_M, group=group,
                                              search="probe")
        warm = fn(points)  # warm-up; its grid gives the kernels' real inputs
        check_giant(warm, "giant warm-up")
        k1_err, k1_giant, lines = giant_kernels(points, warm[4])

        mask = torch.ones(GIANT_N, dtype=torch.bool, device="cuda")
        classes = torch.zeros(GIANT_N, dtype=torch.int32, device="cuda")
        for kernel in KERNELS:
            kernel.launches = 0
        lat, evals = [], []
        with Collectives() as coll:
            for i in range(GIANT_RUNS):
                coll.clear()
                k1, k3 = (sm.fused_moments_sorted.launches,
                          sm.segment_tags_sorted.launches)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(points)
                end.record()
                end.synchronize()
                lat.append(start.elapsed_time(end))
                label = f"giant run {i}"
                nv = check_giant(out, label)
                if sm.fused_moments_sorted.launches - k1 != 1:
                    raise AssertionError(f"{label}: K1 launched "
                                         f"{sm.fused_moments_sorted.launches - k1} times")
                evals.append(check_collectives(
                    coll.calls, sm.segment_tags_sorted.launches - k3, label))
                print(f"{label}: {lat[-1]:.3f} ms (events), voxel size "
                      f"{float(out[4].voxel_size[0]):.6f}, num_valid {nv}, "
                      f"{evals[-1]} search evaluations")
            # the sharded moments at the accepted size against the
            # single-device segment_moments (K2) on the same sorted cloud
            state = out[4]
            mom = ps.sharded_segment_moments(
                group, points, mask, state.voxel_size, state.lens[0],
                state.offsets[0], GIANT_K, 1, classes)
            pts, centres, seg, table = sorted_cloud(points, state)
            ref = moments.segment_moments(pts, centres, seg, GIANT_K,
                                          classes=classes, num_class_slots=1)
        launches = [k.launches for k in KERNELS]
        want = [GIANT_RUNS + 1, sum(evals) + GIANT_RUNS + 1, 1]
        if launches != want:
            raise AssertionError(f"giant path launches {launches} (K1, K3, K2),"
                                 f" expected {want}")

        for name in ("counts", "class_hist"):
            if not torch.equal(mom[name], ref[name]):
                raise AssertionError(f"giant oracle: {name} differ")
        if not torch.equal(mom["table"], table):
            raise AssertionError("giant oracle: voxel tables differ")
        # atol 2e-4 as tests/test_sharding.py, plus twice both kernels'
        # f32 summation bounds (K1 and K2 sum in different orders): a voxel
        # here holds up to ~1800 points and its sum of x~x~' reaches
        # thousands, where one f32 ulp is ~5e-4. One rank: K1's local rows
        # are the table's rows.
        feats = moments.moment_features(pts, centres, classes=classes,
                                        num_class_slots=1)
        tol = 2e-4 + 2 * (k1_error_bound(giant_k1_inputs(points, state))[:, :14]
                          + sm.segment_sum_error_bound(feats, seg, GIANT_K))
        got = torch.cat([mom["sum_shift"], mom["sum_outer"].reshape(-1, 9)], 1)
        want_ = torch.cat([ref["sum_shift"], ref["sum_outer"].reshape(-1, 9)], 1)
        diff = (got - want_).abs()
        if bool((diff.double() > tol[:, 1:13]).any()):
            raise AssertionError(f"giant oracle: sums differ by {float(diff.max())}")
        print(f"giant oracle: counts, table exact; K1 vs K2 sums max diff "
              f"{float(diff.max()):.3e} (entries beyond 2e-4: "
              f"{int((diff > 2e-4).sum())} of {diff.numel()})")

        single = ndt.ndt_downsample(points[None], GIANT_M, search="fast")[4]
        d = abs(float(single.voxel_size[0]) - float(state.voxel_size[0]))
        if d >= 1e-6:
            raise AssertionError(f"giant: accepted size differs from the "
                                 f"single-device fast search by {d}")

        syncs = count_syncs(lambda: fn(points))
        stages = [giant_stages(points, group) for _ in range(GIANT_RUNS)]
        split = {k: statistics.median(r[k] for r in stages) for k in stages[0]}
        n_kernels, busy_ms, wall_ms, top = device_share(lambda: fn(points))
        prune = ndt.ndt_prune(state, GIANT_M // 2)
        if int(prune[3].sum()) != GIANT_M // 2:
            raise AssertionError("giant prune: wrong kept count")
        prune_ms = time_ms(lambda: ndt.ndt_prune(state, GIANT_M // 2))
    finally:
        mesh.release_group()
    med = statistics.median(lat)
    print(f"giant: median {med:.3f} ms/cloud ({1e3 / med:.2f} clouds/s, "
          f"{GIANT_N / med / 1e3:.2f} Mpts/s) over {GIANT_RUNS} runs; "
          f"{syncs} host syncs flagged per downsample; voxel size matches the "
          f"single-device fast search (diff {d:.2e})")
    print("giant stages (median of 5, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"giant profile: {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"of {wall_ms:.3f} ms (idle {1 - busy_ms / wall_ms:.1%}); most "
          "device time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    print(f"giant prune to {GIANT_M // 2}: {prune_ms:.4f} ms (events)")
    print(f"giant launches (K1, K3, K2): {launches}; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    lines[0]["launches"], lines[1]["launches"] = launches[1], launches[2]
    return launches[0], k1_err, k1_giant, lines


# ---- training ----

TRAIN_M = 2080                       # TrainConfig's n_desired_nds
TRAIN_K = ndt.max_segments(TRAIN_M)  # K1 rows on the training path
TRAIN_STEPS = 5                      # timed steps after one warm-up
TRAIN_LR = 1e-3                      # bench.py bench_train's optax.adam(1e-3)
TRAIN_OUT = "build/chip_smoke_train"
# the card-vs-CPU step: eight example_cloud clouds (seeds without a 2- or
# 3-point voxel at 16 NDs) of 1024 points, 4 classes, feature_dim 32.
# Eight, not fewer: BatchNorm over the B rows of a TNet's FC layers is
# ill-conditioned for few rows (at B = 4 the CPU's own f32 gradients lie
# up to 1e-1 of a leaf's largest from float64; at B = 8, 2e-5)
SMALL_SEEDS = (1, 5, 6, 7, 8, 9, 10, 21)
SMALL_N, SMALL_M, SMALL_C, SMALL_F = 1024, 16, 4, 32
STEP_RTOL = 1e-4                     # loss, running statistics (atol 1e-5)
GRAD_TOL = 1e-3                      # of a leaf's largest |grad|
# PointNet on raw coordinates is worse conditioned: on the small batch the
# CPU's own f32 gradients lie up to 5.6e-3 of a leaf's largest from a
# float64 evaluation (1.5e-3 to 1.6e-2 on other batches tried), so each
# device's gradients are held to the float64 step's, not to each other
PN_GRAD_TOL = 2e-2
ADAM_EPS = 1e-8                      # train/state.py's Adam


def train_batch():
    """bench.py bench_train's batch on the card: make_batch(16, 70000,
    seed=0) and int labels default_rng(1).integers(0, 28)."""
    points = torch.from_numpy(make_batch(B, N, seed=0)).cuda()
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, C, (B, N)).astype(np.int32)).cuda()
    return points, labels


def small_batch(fine=SMALL_M, coarse=None):
    """The card-vs-CPU steps' batch: SMALL_SEEDS' clouds and int labels in
    1..4 by the signs of x and y, checked free of 2- and 3-point voxels
    at ``fine`` (and ``coarse``) NDs."""
    pts = np.stack([example_cloud(1, SMALL_N, seed=s)[0] for s in SMALL_SEEDS])
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    for m in (fine, coarse) if coarse else (fine,):
        counts = ndt_preprocessing_with_state(
            m, torch.from_numpy(pts), None, SMALL_C, search="reference")[4].counts
        if bool(((counts == 2) | (counts == 3)).any()):
            raise AssertionError(f"small train batch has a 2/3-point voxel at {m}")
    return pts, labels


def compare_step(label, step, make_state, batch, k1_per_step, rows,
                 grad_tol=GRAD_TOL, ref64=False):
    """One train step of the same TrainState (``make_state(device)``,
    weights from seed 0) on the card and on the CPU: ``k1_per_step`` K1
    launches on the card and none on the CPU, metrics on the step's
    device. The loss and the BN running statistics agree to STEP_RTOL,
    the accuracy to one of its ``rows``, every gradient leaf to
    ``grad_tol`` of its largest |grad| (leaves whose largest is below 1e-6
    of the model's are f32 noise: the biases in front of a BatchNorm), and
    the parameters to 1e-6 where |grad| >= ``grad_tol`` of the leaf's
    largest: Adam's first update is lr * sign(grad), and a sign inside the
    rounding error of the two devices' sums is noise.

    With ``ref64`` the gradients are held instead to those of the same
    step run in float64 on the CPU: each device's, leaf by leaf, within
    ``grad_tol`` of the float64 leaf's largest |grad|, both largest gaps
    printed; the parameters are compared where the float64 |grad| exceeds
    twice the larger gap of the two devices on its leaf (so both signs
    are right) and 4 lr eps / 1e-6 (so Adam's lr g / (|g| + eps) lies
    within 1e-6 of lr sign(g))."""
    out = {}
    runs = (("cuda", "cuda"), ("cpu", "cpu")) + ((("cpu64", "cpu"),)
                                                  if ref64 else ())
    for dev, where in runs:
        state = make_state(where)
        inputs = [torch.from_numpy(a).to(where) for a in batch]
        if dev == "cpu64":
            state.model.double()
            inputs = [a.double() if a.is_floating_point() else a
                      for a in inputs]
        before = sm.fused_moments_sorted.launches
        state, m = step(state, *inputs)
        launched = sm.fused_moments_sorted.launches - before
        want = k1_per_step if dev == "cuda" else 0
        if launched != want or m["loss"].device.type != where:
            raise AssertionError(f"{label} on {dev}: {launched} K1 launches, "
                                 f"loss on {m['loss'].device}")
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in state.model.named_parameters()},
                    {n: b.cpu() for n, b in state.model.named_buffers()})
    (mg, pg, bg), (mc, pc, bc) = out["cuda"], out["cpu"]
    if abs(mg["loss"] - mc["loss"]) > STEP_RTOL * abs(mc["loss"]):
        raise AssertionError(f"{label}: loss {mg['loss']} card, {mc['loss']} CPU")
    if abs(mg["accuracy"] - mc["accuracy"]) > 1 / rows:
        raise AssertionError(f"{label}: accuracy differs card vs CPU")
    for name, ref in bc.items():
        torch.testing.assert_close(bg[name], ref, rtol=STEP_RTOL, atol=1e-5)
    ref = out["cpu64"][1] if ref64 else pc
    gmax = max(float(g.abs().max()) for _, g in ref.values())
    compared, gaps = 0, {"card": 0.0, "CPU": 0.0}
    for name, (p_cpu, g_cpu) in pc.items():
        p_gpu, g_gpu = pg[name]
        g_ref = ref[name][1]
        leaf = float(g_ref.abs().max())
        if leaf < 1e-6 * gmax:
            continue
        if ref64:
            gap = max(float((g - g_ref).abs().max())
                      for g in (g_gpu, g_cpu.double()))
            for dev, g in (("card", g_gpu), ("CPU", g_cpu)):
                rel = float((g.double() - g_ref).abs().max()) / leaf
                gaps[dev] = max(gaps[dev], rel)
                if rel > grad_tol:
                    raise AssertionError(f"{label}: grad of {name} on the "
                                         f"{dev} {rel:.3e} of its largest "
                                         "from float64")
            keep = ((g_ref.abs() > 2 * gap)
                    & (g_ref.abs() >= 4 * TRAIN_LR * ADAM_EPS / 1e-6))
        else:
            if float((g_gpu - g_cpu).abs().max()) > grad_tol * leaf:
                raise AssertionError(f"{label}: grad of {name} differs card "
                                     "vs CPU")
            keep = g_cpu.abs() >= grad_tol * leaf
        torch.testing.assert_close(p_gpu[keep], p_cpu[keep], rtol=0, atol=1e-6)
        compared += int(keep.sum())
    total = sum(p.numel() for p, _ in pc.values())
    print(f"{label}: card == CPU (loss {mg['loss']:.6f} / {mc['loss']:.6f}; "
          f"{compared} of {total} parameters compared"
          + ("; largest gradient gap from float64, of a leaf's largest: "
             f"card {gaps['card']:.3e}, CPU {gaps['CPU']:.3e}" if ref64 else "")
          + ")")


def small_state(model=NDTNetSegmentation, **model_kw):
    """make_state for compare_step: the model at the small width."""
    return lambda dev: create_train_state(SMALL_C, SMALL_F, lambda _: TRAIN_LR,
                                          device=dev, model=model, **model_kw)


def small_step_check():
    """The segmentation train step card vs CPU (compare_step): one K1
    launch on the card."""
    step, _ = make_ndt_seg_step(SMALL_M, SMALL_C, "reference")
    compare_step("train small step", step, small_state(), small_batch(), 1,
                 len(SMALL_SEEDS) * SMALL_M)


def small_cls_step_check():
    """The classification train step card vs CPU (compare_step) on the
    small batch with one-hot labels i % SMALL_C: one K1 launch on the
    card, the accuracy to one cloud."""
    pts, _ = small_batch()
    onehot = np.eye(SMALL_C, dtype=np.float32)[np.arange(len(pts)) % SMALL_C]
    step, _ = make_classification_step(SMALL_M, SMALL_C, "reference")
    compare_step("classification small step", step,
                 small_state(NDTNetClassification), (pts, onehot), 1, len(pts))


def small_multiscale_step_check():
    """The multiscale train step card vs CPU (compare_step) at fine
    SMALL_M and coarse SMALL_M // 2 NDs: two K1 launches on the card."""
    fine, coarse = SMALL_M, SMALL_M // 2
    step, _ = make_multiscale_seg_step(fine, coarse, SMALL_C, "reference")
    compare_step("multiscale small step", step,
                 small_state(NDTNetPPSegmentation, fine_res=fine,
                             coarse_res=coarse),
                 small_batch(fine, coarse), 2, len(SMALL_SEEDS) * fine)


class PrepRecorder:
    """Records, inside the trainer, each preprocessing call's converged
    flags and smallest kept-ND count as device tensors, read after the
    run (no host sync added to the steps), and the ND count it asked for;
    with ``keep``, each call's outputs too (``outs``)."""

    def __init__(self, keep=False):
        self.keep = keep

    def __enter__(self):
        self.calls, self.outs = [], []
        self.saved = train_loop.ndt_preprocessing_with_state

        def prep(*args, **kw):
            out = self.saved(*args, **kw)
            self.calls.append((out[4].converged.all(), out[3].sum(-1).min(),
                               args[0]))
            if self.keep:
                self.outs.append(out)
            return out

        train_loop.ndt_preprocessing_with_state = prep
        return self

    def __exit__(self, *exc):
        train_loop.ndt_preprocessing_with_state = self.saved


class K1Recorder:
    """Keeps, while active, the inputs of the first K1 launch of each
    shape (batch, points, rows, slots, tag columns) that the port's moment
    stage makes, as canonical_inputs gives them, so that check_kernel can
    hold K1 at the shapes and on the data a path really gave it."""

    def __enter__(self):
        self.inputs = {}
        self.saved = moments.fused_moments_sorted

        def k1(xt, yt, zt, v, cls, seg, k, slots, tags=None):
            tags = list(tags or ())
            key = (tuple(xt.shape), k, slots, len(tags))
            self.inputs.setdefault(key, dict(xt=xt, yt=yt, zt=zt, v=v,
                                             cls=cls, seg=seg, tags=tags,
                                             slots=slots, k=k))
            return self.saved(xt, yt, zt, v, cls, seg, k, slots, tags=tags)

        moments.fused_moments_sorted = k1
        return self

    def __exit__(self, *exc):
        moments.fused_moments_sorted = self.saved

    def check(self, label):
        """check_kernel on every recorded shape. Returns the largest
        max_abs_err."""
        if not self.inputs:
            raise AssertionError(f"{label}: no K1 launch recorded")
        return max(check_kernel(x, f"{label} ([{', '.join(map(str, shape))}]"
                                f" -> {k} rows, {slots} slots, {t} tags)")
                   for (shape, k, slots, t), x in self.inputs.items())


def run_trainer(args, main):
    """A trainer's main in this process, its stdout echoed. Returns
    (state, stdout, the logged JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = main(args)
    out = buf.getvalue()
    print(out, end="")
    return state, out, [json.loads(line) for line in out.splitlines()
                        if line.startswith("{")]


def train_stages(step, state, points, labels, preps):
    """One call of the train step with a CUDA event at each boundary of its
    stages: after each preprocessing call (``preps`` names them, one a
    call), then by hooks on the model and the optimizer, after the
    forward, before the optimizer's step (the loss and the backward) and
    after it. A stage includes any wait of the card for the host."""
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    names = iter(preps)
    saved = train_loop.ndt_preprocessing_with_state

    def prep(*args, **kw):
        out = saved(*args, **kw)
        mark(next(names))
        return out

    hooks = [
        state.model.register_forward_hook(lambda *_: mark("forward")),
        state.optimizer.register_step_pre_hook(
            lambda *_: mark("loss + backward")),
        state.optimizer.register_step_post_hook(lambda *_: mark("optimizer")),
    ]
    train_loop.ndt_preprocessing_with_state = prep
    torch.cuda.synchronize()
    try:
        mark("start")
        step(state, points, labels)
        torch.cuda.synchronize()
    finally:
        train_loop.ndt_preprocessing_with_state = saved
        for h in hooks:
            h.remove()
    got = [name for name, _ in marks]
    if got != ["start", *preps, "forward", "loss + backward", "optimizer"]:
        raise AssertionError(f"train stages: marks {got}")
    return {name: marks[i][1].elapsed_time(e)
            for i, (name, e) in enumerate(marks[1:])}


def trainer_runs(label, main, args, resume):
    """A trainer's ``main(args)`` in this process, then, with ``resume``,
    once more from the checkpoint the first run saved. The resumed run
    starts at the first run's step and ends at twice it; every logged loss
    is finite; every cloud of every preprocessing converged with the NDs it
    asked for. Returns (the runs' logged lines, the preprocessings, the
    last step)."""
    t0 = time.perf_counter()
    runs = []
    with PrepRecorder() as rec:
        state, out, logs = run_trainer(args, main)
        runs.append(logs)
        first = state.step
        if resume:
            ckpt = out.split("saved checkpoint to ")[1].split()[0]
            state, out, logs = run_trainer(args + ["--resume", ckpt], main)
            runs.append(logs)
            if (f"resumed from {ckpt} at step {first}" not in out
                    or state.step != 2 * first):
                raise AssertionError(f"{label}: resume ended at step {state.step}")
    losses = [v for logs in runs for log in logs for k, v in log.items()
              if "loss" in k]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: logged losses {losses}")
    if rec.calls:  # the PointNet trainer preprocesses nothing
        converged = torch.stack([c for c, _, _ in rec.calls])
        short = torch.stack([kept - asked for _, kept, asked in rec.calls])
        if not bool(converged.all()) or bool(short.any()):
            raise AssertionError(f"{label}: a cloud did not converge to its NDs")
    mean = {split: [log[f"{split}_mean_loss"] for logs in runs for log in logs
                    if f"{split}_mean_loss" in log]
            for split in ("train", "val", "test")}
    print(f"{label}: {len(runs)} run(s), steps 0 -> {state.step}, "
          f"{len(rec.calls)} preprocessings converged, mean losses by run: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.6g}" for v in vs)
                      for k, vs in mean.items() if vs)
          + "; clouds/s " + " / ".join(str(logs[0]["clouds_per_s"])
                                      for logs in runs)
          + f"; {time.perf_counter() - t0:.1f} s")
    return runs, len(rec.calls), state.step


def timed_train(label, step, state, batch, k1_per_step, preps,
                steps=TRAIN_STEPS):
    """A train step on the card: one warm-up, then ``steps`` timed with
    CUDA events, each with finite metrics and ``k1_per_step`` K1 launches;
    the host syncs of a step against those of its preprocessings alone
    (``preps``: (stage name, NDs, ground truth or None) a call); the stage
    split; peak memory. Returns (median ms, K1 launches of all of it)."""
    k1 = sm.fused_moments_sorted
    start_launches = k1.launches
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, *batch)
    lat, host = [], []
    for i in range(steps):
        before = k1.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, *batch)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        lat.append(start.elapsed_time(end))
        if k1.launches - before != k1_per_step:
            raise AssertionError(f"{label} step {i}: K1 launched "
                                 f"{k1.launches - before} times")
        loss, acc = float(m["loss"]), float(m["accuracy"])
        if not (math.isfinite(loss) and 0 <= acc <= 1):
            raise AssertionError(f"{label} step {i}: loss {loss}, accuracy {acc}")
        print(f"{label} step {i}: {lat[-1]:.3f} ms (events), {host[-1]:.3f} ms "
              f"(host), loss {loss:.4f}, accuracy {acc:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    syncs = count_syncs(lambda: step(state, *batch))
    prep_syncs = sum(count_syncs(lambda: ndt_preprocessing_with_state(
        m, batch[0], gt, C, search="probe")) for _, m, gt in preps)
    if syncs != prep_syncs:
        raise AssertionError(f"{label} step: {syncs} host syncs, its "
                             f"preprocessings alone {prep_syncs}")
    stages = [train_stages(step, state, *batch, preps=[n for n, _, _ in preps])
              for _ in range(steps)]
    split = {k: statistics.median(r[k] for r in stages) for k in stages[0]}
    launches = k1.launches - start_launches
    want = k1_per_step * (2 + 2 * steps) + len(preps)
    if launches != want:
        raise AssertionError(f"{label}: {launches} K1 launches, expected {want}")
    med = statistics.median(lat)
    batch_size = batch[0].shape[0]
    print(f"{label}: median {med:.3f} ms/step (events), "
          f"{statistics.median(host):.3f} ms (host), {batch_size / med * 1e3:.1f} "
          f"clouds/s over {steps} steps; {syncs} host syncs flagged per "
          f"step (the preprocessings' {prep_syncs}); {k1_per_step} K1 "
          f"launch(es) per step; peak memory {peak_gb:.2f} GB")
    print(f"{label} stages (median of {steps}, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    return med, launches


def train_phase():
    """K1 checked and timed on the training batch's real tagged inputs;
    the card-vs-CPU step; the trainer CLI with a resume; the timed steps.
    Returns (K1 launches on the training path, K1's max_abs_err and timing
    keys at the training shape)."""
    t0 = time.perf_counter()
    points, labels = train_batch()
    x = canonical_inputs(points, TRAIN_M, labels)
    if x["k"] != TRAIN_K or x["slots"] != C + 1:
        raise AssertionError("training inputs: wrong K or slots")
    err = check_kernel(x, f"training batch (M {TRAIN_M}, {C + 1} slots)")
    times = k1_times(x, "training batch")
    del x
    small_step_check()
    for kernel in KERNELS:
        kernel.launches = 0
    runs, preps, steps = trainer_runs(
        "trainer", train_cli.main, ["--synthetic_length", "32", "--epochs",
                                    "1", "--save_every", "1", "--out_path",
                                    TRAIN_OUT], resume=True)
    losses = sum(k.endswith("_loss") for logs in runs for log in logs for k in log)
    if (steps, preps, losses, sm.fused_moments_sorted.launches) != (4, 12, 12, 12):
        raise AssertionError(f"trainer: {steps} steps, {preps} preprocessings, "
                             f"{losses} logged losses, "
                             f"{sm.fused_moments_sorted.launches} K1 launches")
    state = create_train_state(C, F, lambda _: TRAIN_LR)
    step, _ = make_ndt_seg_step(TRAIN_M, C, "probe")
    timed_train("train", step, state, (points, labels), 1,
                [("preprocessing", TRAIN_M, labels)])
    launches = sm.fused_moments_sorted.launches
    n_kernels, busy_ms, wall_ms, top = device_share(
        lambda: step(state, points, labels))
    print(f"train profile: {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"of {wall_ms:.3f} ms (idle {1 - busy_ms / wall_ms:.1%}); most "
          "device time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    print(f"train phase took {time.perf_counter() - t0:.1f} s")
    return launches, err, times


# ---- classification and NDT-Net++ ----

CLS_M, CLS_C = 1000, 40              # BASELINE.md's canonical run, ModelNet40's head
CLS_OUT = "build/chip_smoke_cls"
MS_B, MS_FINE, MS_COARSE, MS_F = 4, 8160, 4080, 1024  # bench.py --multiscale
MS_K = ndt.max_segments(MS_FINE)     # K1 rows at the fine resolution
MS_REQUESTS = 3
MS_OUT = "build/chip_smoke_multiscale"


def cls_batch():
    """B SyntheticCls clouds of N points (seed 0) on the card, with their
    labels one-hot over CLS_C classes."""
    ds = SyntheticCls(N, length=B, seed=0)
    pts = np.stack([ds[i][0] for i in range(B)])
    onehot = np.eye(CLS_C, dtype=np.float32)[[ds[i][1] for i in range(B)]]
    return torch.from_numpy(pts).cuda(), torch.from_numpy(onehot).cuda()


def classification_phase():
    """The classification step card vs CPU; then, counted, the trainer
    CLI at full width (B 16, N 70000, M 1000, 40 classes, feature_dim 768,
    SyntheticCls, Adam at 0.034): an epoch of 2 steps with val and test
    evals and a checkpoint, then an epoch resumed from it; and the timed
    steps (one K1 launch each). Returns K1's launches on this path."""
    t0 = time.perf_counter()
    small_cls_step_check()
    for kernel in KERNELS:
        kernel.launches = 0
    _, preps, _ = trainer_runs(
        "classification trainer", train_cli.main,
        ["--task", "classification", "--n_desired_nds", str(CLS_M),
         "--n_classes", str(CLS_C), "--synthetic_length", "32", "--epochs",
         "1", "--save_every", "1", "--out_path", CLS_OUT], resume=True)
    if preps != 12 or sm.fused_moments_sorted.launches != 12:
        raise AssertionError(f"classification trainer: {preps} preprocessings, "
                             f"{sm.fused_moments_sorted.launches} K1 launches")
    state = create_train_state(CLS_C, F, lambda _: TRAIN_LR,
                               model=NDTNetClassification)
    step, _ = make_classification_step(CLS_M, CLS_C, "probe")
    timed_train("classification", step, state, cls_batch(), 1,
                [("preprocessing", CLS_M, None)])
    launches = sm.fused_moments_sorted.launches
    print(f"classification phase took {time.perf_counter() - t0:.1f} s")
    return launches


def multiscale_request(model, points):
    """bench.py's multiscale program: the fine and the coarse untagged
    preprocessing, then the NDT-Net++ forward with its mid-forward prune.
    Returns (logits, fine (state, mask), coarse (state, mask))."""
    with torch.no_grad():
        p1, c1, _, m1, s1 = ndt_preprocessing_with_state(
            MS_FINE, points, None, C, search="probe")
        p2, c2, _, m2, s2 = ndt_preprocessing_with_state(
            MS_COARSE, points, None, C, search="probe")
        return model(p1, c1, s1, p2, c2, return_logits=True), (s1, m1), (s2, m2)


def multiscale_requests():
    """bench.py --multiscale on the card: NDTNetPPSegmentation (28
    classes, fine 8160, coarse 4080, feature_dim 1024, random weights)
    answers a warm-up and MS_REQUESTS timed requests of 4 x 70000-point
    clouds already on the card, each with finite [4, 8160, 29] logits,
    every cloud converged with 8160 and 4080 NDs, and two K1 launches."""
    model = init_random_(NDTNetPPSegmentation(
        num_classes=C, fine_res=MS_FINE, coarse_res=MS_COARSE,
        feature_dim=MS_F), 0).eval()
    requests = [torch.from_numpy(make_batch(MS_B, N, seed=s)).cuda()
                for s in range(1 + MS_REQUESTS)]
    multiscale_request(model, requests[0])  # warm-up
    lat = []
    for i, pts in enumerate(requests[1:]):
        before = sm.fused_moments_sorted.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits, (s1, m1), (s2, m2) = multiscale_request(model, pts)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        lat.append(start.elapsed_time(end))
        label = f"multiscale request {i}"
        if sm.fused_moments_sorted.launches - before != 2:
            raise AssertionError(f"{label}: {sm.fused_moments_sorted.launches - before} "
                                 "K1 launches, expected 2")
        if tuple(logits.shape) != (MS_B, MS_FINE, C + 1):
            raise AssertionError(f"{label}: logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label}: non-finite logits")
        if not (bool(s1.converged.all()) and bool(s2.converged.all())):
            raise AssertionError(f"{label}: a cloud did not converge")
        if not (bool((m1.sum(-1) == MS_FINE).all())
                and bool((m2.sum(-1) == MS_COARSE).all())):
            raise AssertionError(f"{label}: wrong kept ND counts")
        print(f"{label}: {lat[-1]:.3f} ms (events), {host_ms:.3f} ms (host), "
              f"{MS_B / lat[-1] * 1e3:.2f} clouds/s")
    syncs = count_syncs(lambda: multiscale_request(model, requests[1]))
    med = statistics.median(lat)
    print(f"multiscale forward: median {med:.3f} ms/request, "
          f"{MS_B / med * 1e3:.2f} clouds/s; {syncs} host syncs flagged per "
          "request; 2 K1 launches per request")


def multiscale_phase():
    """K1 held against its plain version and timed on the multiscale
    fine batch's real tagged inputs ([4, 70000] -> [4, 9800, 45], 29 class
    slots), and held at the path's other shapes (coarse tagged [4, 4904,
    45], fine and coarse untagged [4, 9800, 16] and [4, 4904, 16]); the
    multiscale step card vs CPU; then, counted, the forward
    requests, the timed full-width train steps (two K1 launches each; the
    stage split fine prep, coarse prep, forward, loss + backward,
    optimizer) and the multiscale trainer CLI at its full width (B 4, N
    70000, fine 8160, coarse 4080, 28 classes, feature_dim 1024) for an
    epoch of 8 steps and 8 val evals. Returns (K1's launches on this path,
    its max_abs_err and timing keys at the fine shape)."""
    t0 = time.perf_counter()
    points = torch.from_numpy(make_batch(MS_B, N, seed=1)).cuda()
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, C, (MS_B, N)).astype(np.int32)).cuda()
    x = canonical_inputs(points, MS_FINE, labels)
    if x["k"] != MS_K or x["slots"] != C + 1:
        raise AssertionError("multiscale inputs: wrong K or slots")
    err = check_kernel(x, f"multiscale fine batch (M {MS_FINE}, {C + 1} slots)")
    times = k1_times(x, "multiscale fine batch")
    del x
    # the path's other K1 shapes: the step's coarse preprocessing (tagged)
    # and a forward request's two (untagged)
    for m, tags in ((MS_COARSE, labels), (MS_FINE, None), (MS_COARSE, None)):
        kind = "untagged" if tags is None else f"{C + 1} slots"
        err = max(err, check_kernel(canonical_inputs(points, m, tags),
                                    f"multiscale batch (M {m}, {kind})"))
    small_multiscale_step_check()
    for kernel in KERNELS:
        kernel.launches = 0
    multiscale_requests()
    state = create_train_state(C, MS_F, lambda _: TRAIN_LR,
                               model=NDTNetPPSegmentation, fine_res=MS_FINE,
                               coarse_res=MS_COARSE)
    step, _ = make_multiscale_seg_step(MS_FINE, MS_COARSE, C, "probe")
    timed_train("multiscale", step, state, (points, labels), 2,
                [("fine prep", MS_FINE, labels),
                 ("coarse prep", MS_COARSE, labels)])
    del state, step
    before = sm.fused_moments_sorted.launches
    _, preps, _ = trainer_runs("multiscale trainer", train_multiscale_cli.main,
                            ["--epochs", "1", "--save_every", "1",
                             "--out_path", MS_OUT], resume=False)
    cli = sm.fused_moments_sorted.launches - before
    if preps != 32 or cli != 32:  # (8 train + 8 val) x (fine + coarse)
        raise AssertionError(f"multiscale trainer: {preps} preprocessings, "
                             f"{cli} K1 launches")
    launches = sm.fused_moments_sorted.launches
    print(f"multiscale phase took {time.perf_counter() - t0:.1f} s")
    return launches, err, times


# ---- the sampler's variants, PointNet and the CARLA data path ----

# (search, key_mode, prune_order); the first is the serving path's, timed
# beside the others in the same call
VARIANTS = (("probe", "packed", "ascending"), ("grid", "packed", "ascending"),
            ("grid", "pair", "ascending"), ("probe", "pair", "ascending"),
            ("probe", "packed", "legacy_c"))
VARIANT_REQUESTS = 3
PRUNE_M = 500                         # ndt_prune's coarse count (legacy_c)
CPU_CLOUDS = (0, B - 1)               # clouds held against the CPU (B - 1: the outlier)
# of the card's kept NDs on CPU_CLOUDS, the share that the full CPU run
# may miss: KLs that rounding moves across the prune's cut (1 to 5 of 1065
# or 2000 on the H100, PERF.md)
KEPT_DIFF_FRAC = 0.01
PN_N = 4160                           # tools/train_pointnet.py's n_samples
PN_OUT = "build/chip_smoke_pointnet"
CARLA_DIR = "build/chip_smoke_carla"
CARLA_CLOUDS = 8                      # PLY files of N points, 29 class tags
CARLA_NDS = 2080                      # CarlaNDTSeg's num_desired_nds
CARLA_ITEMS = 3
# FPS card == CPU: all of PN_N's steps over a smaller exact cloud (the
# CPU's 4159 steps over 70000 points take tens of seconds)
FPS_CHECK_N = 20000
PN_TREE = "build/chip_smoke_pointnet_tree"
PN_TREE_CLOUDS, PN_TREE_N = 16, 8192  # the PointNet trainer's CarlaSeg tree


def outlier_cloud(n, seed):
    """[n, 3] f32: n - 1 points uniform in a 1 m cube plus one point 4 km
    away in x and y. The grid that resolves the cube to 1000 NDs has far
    more than 2**31 cells, while len_z * len_y stays small: packed keys
    cannot reach the band, pair keys can."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n - 1, 3))
    return np.concatenate([pts, [[4000.0, 4000.0, 0.5]]]).astype(np.float32)


def variant_batch():
    """The serving batch (make_batch(16, 70000, seed 1)) with its last
    cloud replaced by the outlier cloud, on the card."""
    pts = make_batch(B, N, seed=1)
    pts[-1] = outlier_cloud(N, seed=7)
    return torch.from_numpy(pts).cuda()


def well_posed(counts, zyx, covs):
    """[K] bool: occupied voxels whose own and every occupied neighbour's
    covariance rest on >= 4 points and has |det| > 1e-3 (tr/3)**3, a
    thousand times the KL's singularity threshold. Elsewhere a KL is
    decided, or scaled up to ~6e-8 x the condition number, by f32
    rounding (ROADMAP.md, faults). One cloud's state on the host, as
    tensors or numpy arrays; the rule by which the card check and the
    CPU tests pick the KLs they compare."""
    counts, zyx, covs = (a if torch.is_tensor(a) else torch.from_numpy(
        np.array(a)) for a in (counts, zyx, covs))
    det = torch.linalg.det(covs.double())
    tr = covs.diagonal(dim1=-2, dim2=-1).sum(-1).double() / 3.0
    good = (counts >= 4) & (det.abs() > 1e-3 * tr**3)
    counts, zyx, good = counts.numpy(), zyx.numpy(), good.numpy()
    bad = {tuple(c) for c in zyx[(counts > 0) & ~good]}
    steps = np.vstack([np.eye(3, dtype=np.int64), -np.eye(3, dtype=np.int64)])
    ok = good.copy()
    for i in np.nonzero(ok)[0]:
        ok[i] = not any(tuple(zyx[i] + d) in bad for d in steps)
    return torch.from_numpy(ok)


def check_variant_vs_cpu(points, out, label, key_mode, prune_order, m=None,
                         clouds=None):
    """The card's downsample of ``clouds`` (CPU_CLOUDS by default) to m
    (M) NDs against the port's CPU path, stage by stage. At the card's
    accepted sizes the CPU's state has the card's integers exactly and
    its means and covariances within f32 rounding. The CPU's KL stage on
    the card's moments gives the card's KLs: finiteness exactly and
    values to 1e-3 where well posed (``well_posed``; elsewhere the
    covariance's condition number scales up their ulp differences, and
    the two devices round a log and a division differently). The CPU's
    emit of the card's state equals the card's emit bit for bit. The kept
    NDs of the two full runs may still differ where rounding moves a KL
    across the prune's cut, in at most KEPT_DIFF_FRAC of the card's kept
    NDs. Returns (the card's kept NDs the CPU run did not keep, the card's
    kept NDs)."""
    m = M if m is None else m
    clouds = CPU_CLOUDS if clouds is None else clouds
    idx = torch.tensor(clouds)
    st = out[4]
    host = ndt.NDTResult(**{f.name: getattr(st, f.name)[idx.cuda()].cpu()
                            for f in dataclasses.fields(ndt.NDTResult)})
    cpu = ndt.ndt_downsample(points[idx.cuda()].cpu(), m,
                             fixed_voxel_size=host.voxel_size,
                             key_mode=key_mode, prune_order=prune_order)
    cs = cpu[4]
    for name in ("voxel_size", "num_valid", "counts", "zyx", "lens",
                 "class_hist"):
        if not torch.equal(getattr(host, name), getattr(cs, name)):
            raise AssertionError(f"{label}: {name} differs card vs CPU")
    vs2 = float(host.voxel_size.max()) ** 2
    torch.testing.assert_close(host.means, cs.means, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(host.covs, cs.covs, rtol=1e-4,
                               atol=1e-5 * max(1.0, vs2))
    kls = neighbor_min_kl(host.means, host.covs, host.counts, host.zyx,
                          host.lens)
    for i in range(len(clouds)):
        ok = well_posed(host.counts[i], host.zyx[i], host.covs[i])
        for name, ref in zip(("min_kl", "max_kl"), kls):
            a, r = getattr(host, name)[i][ok], ref[i][ok]
            if not torch.equal(torch.isinf(a), torch.isinf(r)):
                raise AssertionError(f"{label}: {name} finiteness differs")
            fin = torch.isfinite(r)
            torch.testing.assert_close(a[fin], r[fin], rtol=1e-3, atol=1e-3)
    emitted = ndt._emit(host, m, prune_order)
    for got, want in zip(emitted, out[:4]):
        if not torch.equal(got, want[idx.cuda()].cpu()):
            raise AssertionError(f"{label}: the emit of the card's state "
                                 "differs card vs CPU")
    diff = kept = 0
    for i, b in enumerate(clouds):
        mine = out[0][b][out[3][b]].cpu()
        theirs = cpu[0][i][cpu[3][i]]
        near = torch.cdist(mine.double(), theirs.double()).amin(-1) < 1e-3
        diff += int((~near).sum())
        kept += len(mine)
    if diff > KEPT_DIFF_FRAC * kept:
        raise AssertionError(f"{label}: {diff} of the card's {kept} kept NDs "
                             "are not kept in the full CPU run")
    return diff, kept


def run_variant(points, search, key_mode, prune_order):
    """One downsample of the variant batch to M NDs."""
    return ndt.ndt_downsample(points, M, search=search, key_mode=key_mode,
                              prune_order=prune_order)


def check_variant(out, label, key_mode):
    """Every ordinary cloud converged with M NDs; the outlier cloud
    converged with M NDs under pair keys, unconverged with fewer under
    packed keys; every output finite."""
    st, kept = out[4], out[3].sum(-1)
    if not bool(st.converged[:-1].all()) or not bool((kept[:-1] == M).all()):
        raise AssertionError(f"{label}: an ordinary cloud did not converge "
                             f"to {M} NDs")
    if key_mode == "pair":
        if not bool(st.converged[-1]) or int(kept[-1]) != M:
            raise AssertionError(f"{label}: the outlier cloud did not converge")
    elif bool(st.converged[-1]) or int(kept[-1]) >= M:
        raise AssertionError(f"{label}: the outlier cloud reported converged "
                             "under packed keys")
    if not (bool(torch.isfinite(out[0]).all())
            and bool(torch.isfinite(out[1]).all())):
        raise AssertionError(f"{label}: non-finite outputs")


def prune_check(points, state, out):
    """ndt_prune(state, PRUNE_M, "legacy_c") on the card: every cloud keeps
    min(num_valid, PRUNE_M) NDs, each of them one of the downsample's
    (the removed set is a prefix of one ranking), and the CPU's prune of
    the same state gives the same outputs bit for bit. Returns its ms
    (CUDA events, median of 20)."""
    pruned = ndt.ndt_prune(state, PRUNE_M, "legacy_c")
    want = torch.clamp(state.num_valid, max=PRUNE_M)
    if not torch.equal(pruned[3].sum(-1).to(want.dtype), want):
        raise AssertionError("legacy_c prune: wrong kept counts")
    for b in range(B):
        fine = out[0][b][out[3][b]]
        coarse = pruned[0][b][pruned[3][b]]
        hits = (coarse[:, None, :] == fine[None]).all(-1).any(-1)
        if not bool(hits.all()):
            raise AssertionError(f"legacy_c prune: cloud {b} kept an ND the "
                                 "downsample did not")
    host = ndt.NDTResult(**{f.name: getattr(state, f.name).cpu()
                            for f in dataclasses.fields(ndt.NDTResult)})
    for got, want in zip(ndt._emit(host, PRUNE_M, "legacy_c"), pruned):
        if not torch.equal(got, want.cpu()):
            raise AssertionError("legacy_c prune differs card vs CPU")
    return time_ms(lambda: ndt.ndt_prune(state, PRUNE_M, "legacy_c"))


def ndt_variants_phase():
    """K1 held against its plain version on the pair-key build of the
    variant batch (its outlier cloud gives segment ids and tags the packed
    path never does); then, counted, each variant of VARIANTS: a warm-up
    and VARIANT_REQUESTS timed downsamples, each checked, one K1 launch
    each, the host syncs of one, the CPU_CLOUDS against the CPU; and the
    legacy_c prune. Returns (K1 launches, K1's max_abs_err)."""
    t0 = time.perf_counter()
    points = variant_batch()
    err = check_kernel(canonical_inputs(points, key_mode="pair"),
                       "pair-key variant batch with the outlier cloud")
    for kernel in KERNELS:
        kernel.launches = 0
    k1 = sm.fused_moments_sorted
    for search, key_mode, prune_order in VARIANTS:
        label = f"ndt {search}/{key_mode}/{prune_order}"
        run_variant(points, search, key_mode, prune_order)  # warm-up
        lat, host = [], []
        for i in range(VARIANT_REQUESTS):
            before = k1.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            out = run_variant(points, search, key_mode, prune_order)
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t1) * 1e3)
            lat.append(start.elapsed_time(end))
            if k1.launches - before != 1:
                raise AssertionError(f"{label}: {k1.launches - before} K1 "
                                     "launches, expected 1")
            check_variant(out, f"{label} request {i}", key_mode)
        syncs = count_syncs(lambda: run_variant(points, search, key_mode,
                                                prune_order))
        diff, kept = check_variant_vs_cpu(points, out, label, key_mode,
                                          prune_order)
        med = statistics.median(lat)
        st = out[4]
        print(f"{label}: median {med:.3f} ms/request (events; "
              f"{', '.join(f'{v:.3f}' for v in lat)}), "
              f"{statistics.median(host):.3f} ms (host), "
              f"{B / med * 1e3:.1f} clouds/s; {syncs} host syncs flagged per "
              f"request; outlier cloud converged {bool(st.converged[-1])}, "
              f"kept {int(out[3][-1].sum())}, voxel "
              f"{float(st.voxel_size[-1]):.6f}, len_x {int(st.lens[-1, 0])}; "
              f"card == CPU on clouds {CPU_CLOUDS} ({diff} of {kept} kept "
              "NDs not kept in the full CPU run)")
        if prune_order == "legacy_c":
            prune_ms = prune_check(points, st, out)
            print(f"ndt_prune to {PRUNE_M} (legacy_c): {prune_ms:.4f} ms, "
                  "card == CPU, kept NDs a subset of the downsample's")
    launches = k1.launches
    want = len(VARIANTS) * (VARIANT_REQUESTS + 2)
    if launches != want:
        raise AssertionError(f"ndt variants: {launches} K1 launches, "
                             f"expected {want}")
    print(f"ndt variants phase took {time.perf_counter() - t0:.1f} s")
    return launches, err


def pointnet_batch(n_clouds, n_points, seed):
    """SyntheticSeg clouds (C classes) and their int labels."""
    ds = SyntheticSeg(C, n_points, length=n_clouds, seed=seed)
    pts = np.stack([ds[i][0] for i in range(n_clouds)])
    labels = np.stack([ds[i][1].argmax(-1) for i in range(n_clouds)])
    return pts, labels.astype(np.int32)


def write_seg_tree(path, n_clouds, n_points):
    """A CARLA-style tree of PLY clouds with a class column (SyntheticSeg,
    C + 1 class tags), written unless present. Returns the path."""
    if os.path.isdir(path) and len(os.listdir(path)) == n_clouds:
        return path
    pts, labels = pointnet_batch(n_clouds, n_points, seed=0)
    for i in range(n_clouds):
        write_ply(os.path.join(path, f"cloud_{i:03d}.ply"), pts[i],
                  classes=labels[i])
    return path


def small_pointnet_step_check():
    """The PointNet train step card vs CPU (compare_step), the gradients
    of each against the step in float64: the small batch's clouds and
    labels, no K1 launch."""
    step, _ = make_pointnet_seg_step(SMALL_C)
    compare_step("pointnet small step", step,
                 small_state(PointNetSegmentation), small_batch(), 0,
                 len(SMALL_SEEDS) * SMALL_N, grad_tol=PN_GRAD_TOL, ref64=True)


def pointnet_phase():
    """The PointNet step card vs CPU; TRAIN_STEPS timed steps at the
    trainer's full width (B 16, N 4160, C classes, feature_dim 768) with
    the split forward / loss + backward / optimizer, host syncs (none
    expected) and peak memory; then the PointNet trainer CLI for an epoch
    and a resumed one on a CarlaSeg tree it reads from build/. Returns its
    K1 launches (none)."""
    t0 = time.perf_counter()
    small_pointnet_step_check()
    for kernel in KERNELS:
        kernel.launches = 0
    pts, labels = pointnet_batch(B, PN_N, seed=3)
    batch = (torch.from_numpy(pts).cuda(), torch.from_numpy(labels).cuda())
    state = create_train_state(C, F, lambda _: TRAIN_LR,
                               model=PointNetSegmentation)
    step, _ = make_pointnet_seg_step(C)
    timed_train("pointnet", step, state, batch, 0, [])
    del state, step, batch
    tree = write_seg_tree(PN_TREE, PN_TREE_CLOUDS, PN_TREE_N)
    trainer_runs("pointnet trainer", train_pointnet_cli.main,
                 ["--epochs", "1", "--save_every", "1", "--out_path", PN_OUT,
                  "--train_path", tree, "--val_path", tree, "--test_path",
                  tree], resume=True)
    launches = sm.fused_moments_sorted.launches
    if launches:
        raise AssertionError(f"pointnet: {launches} K1 launches")
    print(f"pointnet phase took {time.perf_counter() - t0:.1f} s")
    return launches


def exact_cloud(n, seed):
    """[n, 3] f32 whose squared distances are exact in f32: integers in
    [-512, 512) times 1/8, so every sum of three squares is a multiple of
    1/64 below 2**16."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-512, 512, size=(n, 3)) / 8.0).astype(np.float32)


def carla_phase():
    """Write CARLA_CLOUDS PLY clouds (N points, C + 1 class tags) under
    build/; read them with the native reader and with numpy (bitwise
    equal, both timed); FPS on the card against the CPU on an
    exact-arithmetic cloud; CarlaNDTSeg (FPS 70000 -> 4160 points on the
    card, then a tagged reference downsample to 2080 NDs) on CARLA_ITEMS
    items, counted: one K1 launch an item, its host syncs, FPS ms a cloud
    and FPS's device share (torch.profiler); then the segmentation trainer
    CLI for an epoch with --train_path,
    --val_path and --test_path on the tree (one K1 launch a step); K1
    held against its plain version on the inputs that the items and the
    trainer gave it (K1Recorder). Returns (K1 launches, K1's max_abs_err,
    FPS entry for the log)."""
    t0 = time.perf_counter()
    tree = write_seg_tree(CARLA_DIR, CARLA_CLOUDS, N)
    files = [os.path.join(tree, f) for f in sorted(os.listdir(tree))]
    t_native, t_numpy = [], []
    for f in files:
        t1 = time.perf_counter()
        a = read_ply(f)
        t_native.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        b = read_ply(f, use_native=False)
        t_numpy.append((time.perf_counter() - t1) * 1e3)
        if not all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b)):
            raise AssertionError(f"read_ply: native differs from numpy on {f}")
    native_ms, numpy_ms = statistics.median(t_native), statistics.median(t_numpy)
    print(f"read_ply ({N} rows, {len(files)} files, median a file): native "
          f"{native_ms:.3f} ms, numpy {numpy_ms:.3f} ms "
          f"({numpy_ms / native_ms:.1f}x), bitwise equal")

    exact = torch.from_numpy(exact_cloud(FPS_CHECK_N, seed=11))
    gpu = farthest_point_sampling(exact.cuda(), PN_N).cpu()
    cpu = farthest_point_sampling(exact, PN_N)
    if not torch.equal(gpu, cpu):
        raise AssertionError("FPS differs card vs CPU on the exact cloud")
    print(f"fps {FPS_CHECK_N} -> {PN_N} on the exact-arithmetic cloud: "
          "card == CPU")

    for kernel in KERNELS:
        kernel.launches = 0
    k1 = sm.fused_moments_sorted
    ds = CarlaNDTSeg(C, PN_N, CARLA_NDS, tree)
    fps_ms, item_ms, syncs = [], [], []
    with K1Recorder() as items:
        for i in range(CARLA_ITEMS):
            pts = torch.from_numpy(read_ply(files[i])[0].astype(np.float32)).cuda()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            farthest_point_sampling(pts, PN_N)
            end.record()
            end.synchronize()
            fps_ms.append(start.elapsed_time(end))
            before = k1.launches
            t1 = time.perf_counter()
            points, gt = ds[i]
            item_ms.append((time.perf_counter() - t1) * 1e3)
            if k1.launches - before != 1:
                raise AssertionError(f"CarlaNDTSeg item {i}: "
                                     f"{k1.launches - before} K1 launches")
            if points.shape != (PN_N, 3) or gt.shape != (CARLA_NDS, C + 1):
                raise AssertionError(f"CarlaNDTSeg item {i}: shapes "
                                     f"{points.shape}, {gt.shape}")
            if not (np.isfinite(points).all() and (gt.sum(-1) == 1).all()):
                raise AssertionError(f"CarlaNDTSeg item {i}: bad values")
            syncs.append(count_syncs(lambda: ds[i]))  # a second, counted item
    fps_med = statistics.median(fps_ms)
    print(f"fps {N} -> {PN_N} points, one cloud on the card: median "
          f"{fps_med:.3f} ms ({', '.join(f'{v:.3f}' for v in fps_ms)}), "
          f"{PN_N - 1} dependent steps")
    n_kernels, busy_ms, wall_ms, top = device_share(
        lambda: farthest_point_sampling(pts, PN_N))
    print(f"fps profile: {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"of {wall_ms:.3f} ms (idle {1 - busy_ms / wall_ms:.1%}, profiler "
          "on); most device time: " + "; ".join(f"{k} {v:.3f} ms"
                                                for k, v in top))
    if k1.launches != 2 * CARLA_ITEMS:
        raise AssertionError(f"CarlaNDTSeg: {k1.launches} K1 launches for "
                             f"{2 * CARLA_ITEMS} items")
    print(f"CarlaNDTSeg ({N} -> {PN_N} FPS points -> {CARLA_NDS} NDs, "
          f"reference search): median {statistics.median(item_ms):.3f} ms "
          f"an item (host clock), one K1 launch an item, host syncs an item "
          f"{syncs}")
    before = k1.launches
    with K1Recorder() as trainer:
        runs, preps, steps = trainer_runs(
            "carla trainer", train_cli.main,
            ["--epochs", "1", "--save_every", "1", "--batch_size",
             str(CARLA_CLOUDS), "--out_path", CARLA_DIR + "_train",
             "--train_path", tree, "--val_path", tree, "--test_path", tree],
            resume=False)
    cli = k1.launches - before
    if (steps, preps, cli) != (1, 3, 3):
        raise AssertionError(f"carla trainer: {steps} steps, {preps} "
                             f"preprocessings, {cli} K1 launches")
    launches = k1.launches
    # K1 against its plain version on the inputs the path gave it: an
    # item's reference-search build ([1, 4160] FPS points, C + 1 slots) and
    # the trainer's batch of CARLA_CLOUDS PLY clouds (tagged)
    err = max(items.check("CarlaNDTSeg item"),
              trainer.check("carla trainer"))
    print(f"carla phase took {time.perf_counter() - t0:.1f} s")
    return launches, err, {"name": "farthest_point_sampling",
                           "ms_per_cloud": fps_med, "steps": PN_N - 1}


# ---- the trainer extras: bf16, the device-resident dataset, the graph epoch ----

EXTRAS_OUT = "build/chip_smoke_extras"
EXTRAS_CLOUDS = 32                    # SyntheticSeg clouds a split (TrainConfig)
GRAPH_TIMED = 5                       # timed one-step graph epochs
PROFILE_ATTEMPTS = 3                  # profiled epochs a graph, at most
PROFILE_PAD_CYCLES = 1_000_000        # spin kernel around a profiled span
K1_NAME = "segment_moments_kernel"    # K1 in a profile
BF16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
# bf16 card vs CPU: the loss of the same step within BF16_LOSS_RTOL (the
# CPU tests hold the port's bf16 step to JAX's at 2e-2)
BF16_LOSS_RTOL = 2e-2


def event_ms(fn, runs=GRAPH_TIMED):
    """Median device time of fn() (CUDA events around it; its host waits
    included), after one untimed run, and the median host ms."""
    fn()
    dev, host = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(host)


def profiled_k1(fn):
    """torch.profiler (the card's activity) over fn(): (fn's result, the K1
    kernels the card ran, every kernel and copy seen). CUPTI reports the
    kernels of a replayed graph one by one. A spin kernel before and
    after fn() keeps fn's kernels off the trace's edges."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(PROFILE_PAD_CYCLES)
        out = fn()
        torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
    k1 = seen = 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            seen += 1
            k1 += K1_NAME in e.name
    return out, k1, seen


def without_sync(fn):
    """fn() with torch's sync debug mode at "error": any op that makes the
    host wait for the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def one_step_order(b):
    """A one-step epoch over the first b clouds: [1, b] on the card."""
    return torch.arange(b, device="cuda").reshape(1, b)


def captured_k1(label, fn, graphs=1):
    """fn(), which captures ``graphs`` CUDA graphs (a first run_epoch_scan
    of a state and dataset, or a trainer run), each of a step that calls
    K1 once: K1's wrapper must have counted ``graphs`` captured calls, so
    that each replay of these graphs launches K1 once. Returns fn()'s
    result."""
    before = sm.fused_moments_sorted.captured
    out = fn()
    got = sm.fused_moments_sorted.captured - before
    if got != graphs:
        raise AssertionError(f"{label}: {got} K1 calls captured into "
                             f"{graphs} graphs")
    return out


def graph_replays(label, scan, state, ds, b, steps=2):
    """The graph epoch checked on the card: a ``steps``-step epoch replayed
    under sync debug mode "error" (no host sync inside) and the profiler,
    which must see K1 once a replay; then GRAPH_TIMED one-step epochs
    timed, without the profiler, after one untimed (event_ms). The
    profiler drops a kernel record now and then (identical profiled
    epochs of one graph see different kernel totals), so an epoch in which
    it saw fewer K1 kernels than replays is profiled again, up to
    PROFILE_ATTEMPTS times in all; more K1 kernels than replays fail at
    once. Returns (median ms a step, host ms, the replays made)."""
    order = torch.arange(steps * b, device="cuda").reshape(steps, b) % len(ds)
    replays = 0
    for attempt in range(PROFILE_ATTEMPTS):
        _, k1, seen = profiled_k1(
            lambda: without_sync(lambda: scan(state, order, *ds.arrays)))
        replays += steps
        if seen == 0:
            raise AssertionError(f"{label}: the profiler saw no kernel of "
                                 "the replays")
        if k1 == steps:
            break
        print(f"{label}: the profiler saw {k1} K1 kernels in {steps} replays "
              f"({seen} kernels), attempt {attempt + 1}")
        if k1 > steps or attempt + 1 == PROFILE_ATTEMPTS:
            raise AssertionError(f"{label}: {k1} K1 launches in {steps} "
                                 "replays")
    ms, host = event_ms(lambda: scan(state, one_step_order(b), *ds.arrays))
    print(f"{label}: graph step median {ms:.3f} ms (events), {host:.3f} ms "
          f"(host), {b / ms * 1e3:.1f} clouds/s; a {steps}-step epoch "
          f"replayed with no host sync (sync debug mode error); K1 {k1} "
          f"launches in {steps} replays (profiler, {seen} kernels)")
    return ms, host, replays + GRAPH_TIMED + 1


def state_gaps(a, b):
    """Largest |a - b| of each state_dict entry of two TrainStates."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return {k: float((sa[k].float() - sb[k].float()).abs().max()) for k in sa}


def compare_epochs(label, eager, graph, me, mg, rows):
    """The graph epoch against the per-step one from the same state: bit
    for bit where nothing differs; otherwise the losses to STEP_RTOL, the
    accuracies to one of ``rows``, the BatchNorm buffers to STEP_RTOL (atol
    1e-5) and each parameter to 1e-6 where its last gradient is not f32
    noise (>= GRAD_TOL of the leaf's largest), compare_step's rules.
    Returns the largest parameter gap."""
    gaps = state_gaps(eager, graph)
    same = all(v == 0 for v in gaps.values()) and me == mg
    print(f"{label}: graph epoch vs per-step epoch: "
          + ("bit-identical" if same else
             f"largest state gap {max(gaps.values()):.3e}, metrics "
             f"{mg} vs {me}"))
    if same:
        return 0.0
    for k in ("last_loss", "mean_loss"):
        if abs(mg[k] - me[k]) > STEP_RTOL * abs(me[k]):
            raise AssertionError(f"{label}: {k} {mg[k]} graph, {me[k]} eager")
    for k in ("last_accuracy", "mean_accuracy"):
        if abs(mg[k] - me[k]) > 1 / rows:
            raise AssertionError(f"{label}: {k} differs")
    ge, gg = dict(eager.model.named_parameters()), dict(graph.model.named_parameters())
    for name, buf in eager.model.named_buffers():
        torch.testing.assert_close(dict(graph.model.named_buffers())[name], buf,
                                   rtol=STEP_RTOL, atol=1e-5)
    for name, p in ge.items():
        g = p.grad
        keep = g.abs() >= GRAD_TOL * g.abs().max()
        torch.testing.assert_close(gg[name][keep], p[keep], rtol=0, atol=1e-6)
    return max(gaps.values())


def seg_graph_epochs():
    """The full-width segmentation state (TrainConfig's width, probe, int
    labels, Adam at TRAIN_LR) and a DeviceCachedDataset of SyntheticSeg
    (EXTRAS_CLOUDS clouds of N points a split): one epoch of 2 steps per
    step (run_epoch over the dataset's loader) and one as the graph
    (run_epoch_scan) with the same order from the same weights, compared;
    the eval graph on the val split against the per-step eval; then the
    graph checked and timed (graph_replays) beside the eager step, with K1
    held against its plain version on the inputs the graph path gave it
    (K1Recorder over the warm-up steps, checked by the caller after it has
    read the launch counts). Returns (the recorder, the largest parameter
    gap, the replays made, the timings)."""
    splits = [DeviceCachedDataset(make_dataset(
        C, N, synthetic_length=EXTRAS_CLOUDS, seed=s, int_labels=True), "cuda")
        for s in (0, 1)]
    train_ds, val_ds = splits
    mb = sum(a.numel() * a.element_size() for a in train_ds.arrays) / 1e6
    print(f"DeviceCachedDataset: {len(train_ds)} clouds, "
          f"{[tuple(a.shape) for a in train_ds.arrays]}, {mb:.1f} MB on the card")
    step, eval_step = make_ndt_seg_step(TRAIN_M, C, "probe")
    # the graph's optimizer form on both sides: only the mechanics differ
    eager = make_capturable(create_train_state(C, F, lambda _: TRAIN_LR))
    eager, me = train_cli.run_epoch(step, eager, train_ds.loader(B, True, 0), True)
    graph = create_train_state(C, F, lambda _: TRAIN_LR)
    train_scan, eval_scan = make_epoch_scan(step), make_epoch_scan(eval_step, False)
    steps = len(train_ds) // B
    with K1Recorder() as rec:
        graph, mg = captured_k1("segmentation epoch", lambda: run_epoch_scan(
            train_scan, graph, train_ds, B, True, 0))
    replays = steps
    if graph.step != eager.step or graph.step != steps:
        raise AssertionError(f"graph epoch: step {graph.step}")
    gap = compare_epochs("segmentation", eager, graph, me, mg, 2 * B * TRAIN_M)
    ve = train_cli.run_epoch(eval_step, graph, val_ds.loader(B, False), False)[1]
    vg = captured_k1("segmentation eval epoch", lambda: run_epoch_scan(
        eval_scan, graph, val_ds, B, False))[1]
    replays += len(val_ds) // B
    for k, v in ve.items():
        if abs(vg[k] - v) > STEP_RTOL * abs(v):
            raise AssertionError(f"eval graph: {k} {vg[k]}, per step {v}")
    print(f"eval graph on the val split: {vg} (per step {ve})")
    ms, host, r = graph_replays("segmentation", train_scan, graph, train_ds, B)
    eval_ms, _, r2 = graph_replays("segmentation eval", eval_scan, graph,
                                   val_ds, B)
    # one more replay, under device_share's profiler
    n_kernels, busy_ms, wall_ms, top = device_share(
        lambda: train_scan(graph, one_step_order(B), *train_ds.arrays))
    replays += r + r2 + 1
    print(f"graph step profile: {n_kernels} kernels, device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms (idle {1 - busy_ms / wall_ms:.1%},"
          " profiler on); most device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    batch = tuple(a[:B] for a in train_ds.arrays)
    eager_ms, eager_host = event_ms(lambda: step(eager, *batch))
    print(f"segmentation eager step (same call): median {eager_ms:.3f} ms "
          f"(events), {eager_host:.3f} ms (host); graph {ms:.3f} ms")
    prep = fixed_rounds_cost(*batch)
    return rec, gap, replays, {
        "graph_step_ms": ms, "graph_step_host_ms": host,
        "graph_step_busy_ms": busy_ms, "graph_step_wall_ms": wall_ms,
        "eval_graph_step_ms": eval_ms, "eager_step_ms": eager_ms,
        "eager_step_host_ms": eager_host, **prep}


def fixed_rounds_cost(points, labels):
    """The sync-free preprocessing (_fixed_rounds: every search round over
    the whole batch) against the eager one on the same batch: outputs
    equal bit for bit on the card; times in turns."""
    def prep(fixed):
        if fixed:
            with _fixed_rounds():
                return ndt_preprocessing_with_state(TRAIN_M, points, labels, C,
                                                    search="probe")
        return ndt_preprocessing_with_state(TRAIN_M, points, labels, C,
                                            search="probe")

    a, b = prep(False), prep(True)
    for x, y in zip(a[:4], b[:4]):
        if not torch.equal(x, y):
            raise AssertionError("fixed rounds: outputs differ from eager")
    for f in dataclasses.fields(ndt.NDTResult):
        x, y = getattr(a[4], f.name), getattr(b[4], f.name)
        if not torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)):
            raise AssertionError(f"fixed rounds: state {f.name} differs")
    times = {False: [], True: []}
    for fixed in (False, True, True, False) * 2:
        times[fixed].append(event_ms(lambda: prep(fixed), runs=3))
    (e_ms, e_host), (f_ms, f_host) = (
        tuple(statistics.median(t[i] for t in times[k]) for i in (0, 1))
        for k in (False, True))
    syncs = count_syncs(lambda: prep(False)), count_syncs(lambda: prep(True))
    print(f"preprocessing (M {TRAIN_M}, tagged, probe): eager {e_ms:.3f} ms "
          f"(events), {e_host:.3f} ms (host), {syncs[0]} host syncs; fixed "
          f"rounds {f_ms:.3f} ms, {f_host:.3f} ms (host), {syncs[1]} host "
          "syncs; outputs bit-identical")
    if syncs[1]:
        raise AssertionError("fixed rounds: the preprocessing synced")
    return {"eager_prep_ms": e_ms, "fixed_rounds_prep_ms": f_ms,
            "eager_prep_host_ms": e_host, "fixed_rounds_prep_host_ms": f_host}


def streaming_and_cls_graphs():
    """The --streaming graph (the searched sizes as the dataset's third
    array: no search in the step), the same in bf16 (compute and
    parameters: only the model differs) and the classification graph (M 1000, 40
    classes, untagged) at full width, each checked and timed
    (graph_replays). Returns (timings, the replays made)."""
    cfg = TrainConfig.from_args(["--streaming"])
    host = make_dataset(C, N, synthetic_length=EXTRAS_CLOUDS, seed=0,
                        int_labels=True)
    ds = DeviceCachedDataset(train_cli.precompute_voxel_sizes(host, cfg), "cuda")
    step, _ = make_ndt_seg_step(TRAIN_M, C, "probe")
    state = create_train_state(C, F, lambda _: TRAIN_LR)
    steps = EXTRAS_CLOUDS // B
    scan = make_epoch_scan(step)
    captured_k1("streaming epoch", lambda: run_epoch_scan(scan, state, ds, B))
    stream_ms, _, r1 = graph_replays("streaming", scan, state, ds, B)
    r1 += steps
    state = create_train_state(C, F, lambda _: TRAIN_LR, **BF16)
    scan = make_epoch_scan(step)
    captured_k1("bf16 streaming epoch",
                lambda: run_epoch_scan(scan, state, ds, B))
    bf16_ms, _, r = graph_replays("bf16 streaming", scan, state, ds, B)
    r1 += steps + r
    del ds, state, scan
    cfg = TrainConfig.from_args(["--task", "classification", "--n_desired_nds",
                                 str(CLS_M), "--n_classes", str(CLS_C)])
    ds = DeviceCachedDataset(train_cli.make_cls_dataset(cfg, "train", 0), "cuda")
    step, _ = make_classification_step(CLS_M, CLS_C, "probe")
    state = create_train_state(CLS_C, F, lambda _: TRAIN_LR,
                               model=NDTNetClassification)
    scan = make_epoch_scan(step)
    captured_k1("classification epoch",
                lambda: run_epoch_scan(scan, state, ds, B))
    cls_ms, _, r2 = graph_replays("classification", scan, state, ds, B)
    r2 += len(ds) // B
    eager_ms, _ = event_ms(lambda: step(state, *(a[:B] for a in ds.arrays)))
    print(f"classification eager step (same call): {eager_ms:.3f} ms")
    return {"streaming_graph_step_ms": stream_ms,
            "bf16_streaming_graph_step_ms": bf16_ms,
            "cls_graph_step_ms": cls_ms, "cls_eager_step_ms": eager_ms}, r1 + r2


def bf16_step_check():
    """The bf16 segmentation step (compute and parameters bfloat16) on the
    card against the CPU from the same weights: the loss within
    BF16_LOSS_RTOL; parameters and Adam's moments bfloat16; where the
    two gradients agree in sign and are not bf16 noise (>= 5e-2 of the
    leaf's largest on both; leaves below 1e-3 of the model's largest
    skipped), the parameters within one bf16 ulp plus 3 % of lr (the CPU
    tests' rule against JAX)."""
    step, _ = make_ndt_seg_step(SMALL_M, SMALL_C, "reference")
    pts, labels = small_batch()
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(SMALL_C, SMALL_F, lambda _: TRAIN_LR,
                                   device=dev, **BF16)
        state, m = step(state, torch.from_numpy(pts).to(dev),
                        torch.from_numpy(labels).to(dev))
        out[dev] = (float(m["loss"]), state)
    (lg, sg), (lc, sc) = out["cuda"], out["cpu"]
    if abs(lg - lc) > BF16_LOSS_RTOL * abs(lc):
        raise AssertionError(f"bf16 small step: loss {lg} card, {lc} CPU")
    pg, pc = dict(sg.model.named_parameters()), dict(sc.model.named_parameters())
    gmax = max(float(p.grad.float().abs().max()) for p in pc.values())
    compared = 0
    for name, p in pc.items():
        q = pg[name]
        if p.dtype != torch.bfloat16 or q.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 small step: {name} is {q.dtype}")
        g, h = p.grad.float(), q.grad.float().cpu()
        if float(g.abs().max()) < 1e-3 * gmax:
            continue
        keep = ((g.sign() == h.sign()) & (g.abs() >= 5e-2 * g.abs().max())
                & (h.abs() >= 5e-2 * h.abs().max()))
        want, got = p.detach().float()[keep], q.detach().float().cpu()[keep]
        tol = want.abs() * 2.0**-7 + 0.03 * TRAIN_LR
        if bool(((got - want).abs() > tol).any()):
            raise AssertionError(f"bf16 small step: {name} differs card vs CPU")
        compared += int(keep.sum())
    moments = {v.dtype for s in sg.optimizer.state.values()
               for k, v in s.items() if k != "step"}
    if moments != {torch.bfloat16}:
        raise AssertionError(f"bf16 small step: Adam's moments {moments}")
    print(f"bf16 small step: card vs CPU loss {lg:.6f} / {lc:.6f} (gap "
          f"{abs(lg - lc) / abs(lc):.3e}); {compared} parameters compared; "
          "parameters and moments bfloat16")


def bf16_steps():
    """5 timed full-width bf16 steps (compute and parameters bfloat16) of
    each trainer's step, with the stage split, host syncs, K1 launches and
    peak memory (timed_train), parameters checked bfloat16; then 3 timed
    bf16 serving requests (compute bf16, parameters and preprocessing
    f32). Returns the median ms of each."""
    out = {}
    points, labels = train_batch()
    ms_points = torch.from_numpy(make_batch(MS_B, N, seed=1)).cuda()
    ms_labels = labels[:MS_B]
    pn_pts, pn_labels = pointnet_batch(B, PN_N, seed=3)
    runs = (
        ("bf16 segmentation", NDTNetSegmentation, {}, C,
         make_ndt_seg_step(TRAIN_M, C, "probe")[0], (points, labels), 1,
         [("preprocessing", TRAIN_M, labels)]),
        ("bf16 classification", NDTNetClassification, {}, CLS_C,
         make_classification_step(CLS_M, CLS_C, "probe")[0], cls_batch(), 1,
         [("preprocessing", CLS_M, None)]),
        ("bf16 multiscale", NDTNetPPSegmentation,
         dict(fine_res=MS_FINE, coarse_res=MS_COARSE), C,
         make_multiscale_seg_step(MS_FINE, MS_COARSE, C, "probe")[0],
         (ms_points, ms_labels), 2,
         [("fine prep", MS_FINE, ms_labels),
          ("coarse prep", MS_COARSE, ms_labels)]),
        ("bf16 pointnet", PointNetSegmentation, {}, C,
         make_pointnet_seg_step(C)[0],
         (torch.from_numpy(pn_pts).cuda(), torch.from_numpy(pn_labels).cuda()),
         0, []),
    )
    for label, model, kw, classes, step, batch, k1, preps in runs:
        width = MS_F if model is NDTNetPPSegmentation else F
        state = create_train_state(classes, width, lambda _: TRAIN_LR,
                                   model=model, **kw, **BF16)
        out[label], _ = timed_train(label, step, state, batch, k1, preps)
        dtypes = {t.dtype for t in state.model.state_dict().values()}
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"{label}: parameters {dtypes}")
        del state
    pipe = SegmentationPipeline(n_desired=M, num_classes=C, feature_dim=F,
                                dtype=torch.bfloat16)
    if {p.dtype for p in pipe.model.parameters()} != {torch.float32}:
        raise AssertionError("bf16 serving: parameters not float32")
    requests = [make_batch(B, N, seed=s) for s in (1, 2, 3)]
    pipe(requests[0])
    lat = []
    for i, pts in enumerate(requests):
        before = sm.fused_moments_sorted.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, mask, st = pipe(pts)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if sm.fused_moments_sorted.launches - before != 1:
            raise AssertionError(f"bf16 request {i}: K1 launches "
                                 f"{sm.fused_moments_sorted.launches - before}")
        if (logits.dtype != torch.bfloat16 or tuple(logits.shape) != (B, M, C + 1)
                or not bool(torch.isfinite(logits).all())
                or not bool(st.converged.all())):
            raise AssertionError(f"bf16 request {i}: bad logits or search")
        lat.append(ms)
        print(f"bf16 serve request {i}: {ms:.3f} ms (events)")
    out["bf16 serving"] = statistics.median(lat)
    print(f"bf16 serving: median {out['bf16 serving']:.3f} ms/request")
    return out


def adam_modes():
    """The eager segmentation step's optimizer stage (train_stages) with
    the plain Adam that an eager step keeps (its rate a number, its
    counters on the host) and with the capturable one that a graph's state
    takes (``make_capturable``), in f32 and in bf16, the two forms
    alternated in this call. Returns the median ms of each."""
    points, labels = train_batch()
    step = make_ndt_seg_step(TRAIN_M, C, "probe")[0]
    out = {}
    for label, kw in (("f32", {}), ("bf16", BF16)):
        states = {}
        for capturable in (True, False):
            state = create_train_state(C, F, lambda _: TRAIN_LR, **kw)
            if capturable:
                make_capturable(state)
            step(state, points, labels)  # Adam's moments made
            states[capturable] = state
        ms = {True: [], False: []}
        for capturable in (True, False, False, True) * 2:
            ms[capturable].append(train_stages(
                step, states[capturable], points, labels,
                ["preprocessing"])["optimizer"])
        for capturable, runs in ms.items():
            out[f"{label}_{'capturable' if capturable else 'plain'}_adam_ms"] = (
                statistics.median(runs))
        print(f"{label} eager segmentation step, optimizer stage (median of "
              f"4): capturable Adam {statistics.median(ms[True]):.3f} ms, "
              f"plain Adam {statistics.median(ms[False]):.3f} ms")
        del states
    return out


def extras_phase():
    """The trainer extras at full width: the graph epochs (segmentation
    against its per-step epoch, eval, streaming, classification) with no
    host sync in a replay and K1 once a replay; the sync-free search's
    cost; peak memory; the bf16 small step card vs CPU, the four bf16
    steps and bf16 serving; the optimizer stage with capturable and plain
    Adam; the trainer CLI with --device_cache --compute_dtype bfloat16
    for an epoch and a resumed one. Returns (K1 launches on this path:
    its wrapper's count, which holds the eager launches, plus one for each
    replay of a graph that captured one K1 call (captured_k1, and the
    profiler saw K1 once a replay: graph_replays); K1's max_abs_err on the
    graph path's inputs, checked after the count; timings)."""
    t0 = time.perf_counter()
    for kernel in KERNELS:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec, gap, replays, times = seg_graph_epochs()
    more, r = streaming_and_cls_graphs()
    times.update(more, graph_vs_eager_param_gap=gap)
    replays += r
    times["graph_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"graph phase peak memory {times['graph_peak_gb']:.2f} GB")
    bf16_step_check()
    times.update(bf16_steps())
    times.update(adam_modes())
    # 2 runs, each capturing a train, a val and a test graph and replaying
    # each once a batch
    runs, preps, steps = captured_k1(
        "bf16 device_cache trainer", lambda: trainer_runs(
            "bf16 device_cache trainer", train_cli.main,
            ["--device_cache", "--compute_dtype", "bfloat16",
             "--synthetic_length", str(EXTRAS_CLOUDS), "--epochs", "1",
             "--save_every", "1", "--out_path", EXTRAS_OUT], resume=True),
        graphs=6)
    if steps != 4:
        raise AssertionError(f"bf16 device_cache trainer: {steps} steps")
    replays += 2 * 3 * (EXTRAS_CLOUDS // B)
    eager = sm.fused_moments_sorted.launches
    launches = eager + replays
    print(f"trainer extras: K1 {launches} launches: {eager} eager (counted "
          f"by its wrapper: per-step epochs, warm-ups, eager and bf16 steps, "
          f"requests) + {replays} graph replays of one captured K1 call "
          f"each; phase took {time.perf_counter() - t0:.1f} s")
    err = rec.check("graph path (warm-up steps)")
    return launches, err, times


# ---- data parallelism ----

DP_OUT = "build/chip_smoke_dp"
DP_TIMED = 3                          # timed DP steps of the multiscale and PointNet steps
# the two-rank check's width and rates (two gloo ranks on the one card)
TR_B, TR_N, TR_M, TR_F, TR_C = 4, 8192, 256, 64, 4
TR_LRS = (0.0, 1e-3)
TR_STEPS = 2
F64 = dict(dtype=torch.float64, param_dtype=torch.float64)


# The DP step on a one-rank NCCL group against the step without a group
# (dp_step_check), both from the seed-0 weights on the same batch. In
# float64 (compute and parameters; the preprocessing and K1 stay float32)
# the two compute one step, their sums only grouped otherwise: every
# gradient leaf within DP64_GRAD_TOL of its largest |grad| (measured on an
# NVIDIA H100 80GB HBM3, 700 W: 1.3e-13 segmentation, 4.2e-12 multiscale,
# 5.7e-14 PointNet). The float32 DP step, the trainers' default, is held
# to that float64 step leaf by leaf (compare_step's ref64 rules) within
# its model's DP32_GRAD_TOL, about 2.4x the largest gap measured there
# (4.2e-2 segmentation, 1.05e-1 multiscale, 4.7e-3 PointNet; 1.1e-5 for
# the small step): float32 rounding through the BatchNorms over the B
# rows of the TNets' FC layers moves a leaf by up to a tenth at B 4.
DP64_GRAD_TOL = 1e-9
DP32_GRAD_TOL = {"segmentation": 1e-1, "multiscale": 2.5e-1,
                 "pointnet": PN_GRAD_TOL}


def hold_to_float64(label, what, got, ref, rows, grad_tol, exact):
    """A TrainState after one step and its metrics (``got``) against the
    float64 step's (``ref``). The loss to STEP_RTOL, the accuracy to one of
    ``rows`` (plus two float32 ulps: both are float32 fractions of a hit
    count); each gradient leaf within ``grad_tol`` of the float64 leaf's
    largest |grad| (leaves whose largest is below 1e-6 of the model's are
    noise: the biases in front of a BatchNorm). With ``exact`` (both
    float64) the running statistics to STEP_RTOL (atol 1e-5) and every
    parameter to 1e-6 where |grad| >= GRAD_TOL of its leaf's largest;
    otherwise the parameters where the float64 |grad| exceeds twice the
    leaf's gap and 4 lr eps / 1e-6 (compare_step's ref64 rules), and the
    running statistics' gap is only printed, as a share of the exact
    rule's limit. Prints the largest gaps, then raises on every limit
    broken. Returns the readings."""
    (state, m), (state64, m64) = got, ref
    bad = []
    loss_gap = abs(m["loss"] - m64["loss"]) / abs(m64["loss"])
    acc_rows = abs(m["accuracy"] - m64["accuracy"]) * rows
    if loss_gap > STEP_RTOL:
        bad.append(f"loss {m['loss']} against {m64['loss']}")
    ulp = float(np.spacing(np.float32(max(m["accuracy"], m64["accuracy"]))))
    if abs(m["accuracy"] - m64["accuracy"]) > 1 / rows + 2 * ulp:
        bad.append(f"accuracy {m['accuracy']} against {m64['accuracy']}")
    bufs = dict(state.model.named_buffers())
    buf_gap = 0.0  # the largest |b - b64| / (1e-5 + STEP_RTOL |b64|)
    for name, b64 in state64.model.named_buffers():
        b = bufs[name].double()
        buf_gap = max(buf_gap, float(((b - b64).abs()
                                      / (1e-5 + STEP_RTOL * b64.abs())).max()))
        if exact and not torch.allclose(b, b64, rtol=STEP_RTOL, atol=1e-5):
            bad.append(f"running statistic {name}")
    params = dict(state.model.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in state64.model.parameters())
    worst, worst_leaf, compared, total = 0.0, None, 0, 0
    for name, p64 in state64.model.named_parameters():
        g64, p = p64.grad, params[name]
        total += p64.numel()
        leaf = float(g64.abs().max())
        if leaf < 1e-6 * gmax:
            continue
        gap = float((p.grad.double() - g64).abs().max())
        if gap / leaf >= worst:
            worst, worst_leaf = gap / leaf, name
        if gap > grad_tol * leaf:
            bad.append(f"grad of {name} {gap / leaf:.3e} of its largest")
        if exact:
            keep = g64.abs() >= GRAD_TOL * leaf
        else:
            keep = (g64.abs() > 2 * gap) & (g64.abs() >= 4 * TRAIN_LR * ADAM_EPS / 1e-6)
        off = float((p.detach().double()[keep] - p64.detach()[keep]).abs().max()
                    ) if bool(keep.any()) else 0.0
        if off > 1e-6:
            bad.append(f"parameter {name} {off:.3e} apart")
        compared += int(keep.sum())
    print(f"{label}: {what}: loss {m['loss']!r} / {m64['loss']!r} (gap "
          f"{loss_gap:.3e}), accuracy {acc_rows:.3f} rows apart; largest "
          f"gradient gap of a leaf, of its largest, {worst:.3e} ({worst_leaf}; "
          f"limit {grad_tol:g}); running statistics at {buf_gap:.3e} of "
          f"rtol {STEP_RTOL:g} / atol 1e-5; {compared} of {total} parameters "
          "compared")
    if bad:
        raise AssertionError(f"{label}: {what}: " + "; ".join(bad))
    return {"grad_gap": worst, "loss_gap": loss_gap, "accuracy_rows": acc_rows,
            "buffer_gap": buf_gap}


def dp_step_check(label, step, make_state, batch, k1_per_step, rows,
                  grad_tol):
    """One train step from the seed-0 weights (``make_state(**types)``)
    on ``batch``, three times: in float64 without a data group, then on a
    one-rank NCCL data group in float64 and in float32, ``k1_per_step``
    K1 launches each. The float64 DP step held to the float64 step
    within DP64_GRAD_TOL (hold_to_float64, exact), the float32 DP step
    within ``grad_tol``; the float32 DP step's collectives all-reduces
    only, their bytes within [param_bytes, 1.15 param_bytes + 4096]
    (tests/test_collectives.py:60-73). Returns the collectives (count,
    bytes, parameter bytes) and the gaps."""
    k1 = sm.fused_moments_sorted

    def run(state, counted=contextlib.nullcontext()):
        before = k1.launches
        with counted:
            state, m = step(state, *batch)
        if k1.launches - before != k1_per_step:
            raise AssertionError(f"{label}: K1 launched {k1.launches - before} "
                                 f"times in a step, expected {k1_per_step}")
        return state, {k: float(v) for k, v in m.items()}

    ref = run(make_state(**F64))
    mesh.make_data_group("cuda")
    try:
        dp64 = run(make_state(**F64))
        coll = Collectives()
        dp32 = run(make_state(), coll)
    finally:
        mesh.release_group()
    moved = coll.nbytes["all_reduce"]
    param_bytes = sum(p.numel() * p.element_size()
                      for p in dp32[0].model.parameters())
    if ({c.op for c in coll.log} != {"all_reduce"}
            or not param_bytes <= moved <= 1.15 * param_bytes + 4096):
        raise AssertionError(f"{label}: DP step collectives {dict(coll.calls)}, "
                             f"{moved} bytes, parameters {param_bytes}")
    gaps64 = hold_to_float64(label, "float64 DP step vs the float64 step",
                             dp64, ref, rows, DP64_GRAD_TOL, True)
    gaps32 = hold_to_float64(label, "float32 DP step vs the float64 step",
                             dp32, ref, rows, grad_tol, False)
    print(f"{label}: a float32 DP step makes {len(coll.log)} all-reduces of "
          f"{moved} bytes ({moved / param_bytes:.4f} x the parameters' "
          f"{param_bytes})")
    return {"collectives": len(coll.log), "bytes": moved,
            "param_bytes": param_bytes, "float64": gaps64, "float32": gaps32}


def small_dp_step_check():
    """dp_step_check at the small width (the card-vs-CPU steps' batch):
    one K1 launch a step."""
    step, _ = make_ndt_seg_step(SMALL_M, SMALL_C, "reference")
    batch = tuple(torch.from_numpy(a).cuda() for a in small_batch())
    return dp_step_check(
        "small DP step", step, lambda **kw: create_train_state(
            SMALL_C, SMALL_F, lambda _: TRAIN_LR, **kw),
        batch, 1, len(SMALL_SEEDS) * SMALL_M, DP32_GRAD_TOL["segmentation"])


def two_rank_batch():
    """The two-rank check's global batch: make_batch(TR_B, TR_N, seed 5)
    and int labels default_rng(6).integers(0, TR_C), on the CPU."""
    points = torch.from_numpy(make_batch(TR_B, TR_N, seed=5))
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        0, TR_C, (TR_B, TR_N)).astype(np.int32))
    return points, labels


def two_rank_runs(rank=None):
    """For each rate of TR_LRS, TR_STEPS segmentation steps (probe search,
    float64 compute and parameters) from the seed-0 state on the card: on
    the whole global batch (``rank`` None) or on rank ``rank``'s strided
    half of it. Returns {lr: (each step's metrics, the final state_dict,
    the gradients of the last step), on the CPU}."""
    points, labels = two_rank_batch()
    if rank is not None:
        points, labels = points[rank::2], labels[rank::2]
    points, labels = points.cuda(), labels.cuda()
    step, _ = make_ndt_seg_step(TR_M, TR_C, "probe")
    out = {}
    for lr in TR_LRS:
        state = create_train_state(TR_C, TR_F, lambda _, lr=lr: lr, **F64)
        metrics = []
        for _ in range(TR_STEPS):
            state, m = step(state, points, labels)
            metrics.append({k: float(v) for k, v in m.items()})
        out[lr] = (metrics,
                   {k: v.cpu() for k, v in state.model.state_dict().items()},
                   {n: p.grad.cpu() for n, p in state.model.named_parameters()})
    return out


def dp_worker(rank, port, out):
    """One rank of the two-rank check: joins a gloo group of two
    processes on the one card (NCCL takes one rank a card), runs
    ``two_rank_runs(rank)`` and saves its results and its K1 launches to
    ``out``. Rank 0 prints its metrics; rank 1 prints nothing."""
    mesh.init_distributed(f"localhost:{port}", 2, rank, device="cuda",
                          backend="gloo")
    try:
        sm.fused_moments_sorted.launches = 0
        runs = two_rank_runs(rank)
        launches = sm.fused_moments_sorted.launches
    finally:
        mesh.release_group()
    torch.save({"runs": runs, "launches": launches}, out)
    if rank == 0:
        print(json.dumps({str(lr): m for lr, (m, _, _) in runs.items()}))
    return 0


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def two_rank_gloo_check():
    """Two worker processes (``chip_smoke.py --dp_worker``), each on the
    one card in a gloo group, take TR_STEPS DP steps at each rate of
    TR_LRS (float64) on their halves of the global batch; this process
    takes the same steps on the whole batch with no group. The losses to
    rtol 1e-5 at lr 0 and 1e-6 at lr 1e-3, the accuracies to 1e-6 (the
    CPU tests' tolerances), the parameters and running statistics to the
    same rtol (atol 1e-9); rank 1 prints nothing. Returns the workers' K1
    launches."""
    os.makedirs(DP_OUT, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    outs = [os.path.abspath(os.path.join(DP_OUT, f"rank{r}.pt")) for r in (0, 1)]
    env = dict(os.environ, PYTHONPATH=here)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp_worker", str(r),
         str(port), outs[r]], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        results = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise AssertionError(f"two-rank worker {r} failed:\n{out}\n{err[-3000:]}")
    if results[1][0].strip():
        raise AssertionError(f"rank 1 printed: {results[1][0]!r}")
    got = [torch.load(o, weights_only=False) for o in outs]
    want = two_rank_runs()
    for lr in TR_LRS:
        rtol = 1e-6 if lr else 1e-5
        (m_ref, s_ref, _), (m0, s0, _), (m1, s1, _) = (
            want[lr], got[0]["runs"][lr], got[1]["runs"][lr])
        for i, (a, b, c) in enumerate(zip(m_ref, m0, m1)):
            for k in a:
                tol = rtol * abs(a[k]) if "loss" in k else 1e-6
                if abs(b[k] - a[k]) > tol or b[k] != c[k]:
                    raise AssertionError(f"two ranks, lr {lr}, step {i}: {k} "
                                         f"{b[k]} / {c[k]}, one process {a[k]}")
        for k, v in s_ref.items():
            if not torch.equal(s0[k], s1[k]):
                raise AssertionError(f"two ranks, lr {lr}: {k} differs by rank")
            torch.testing.assert_close(s0[k], v, rtol=rtol, atol=1e-9)
        gap = max(float((s0[k] - v).abs().max()) for k, v in s_ref.items())
        print(f"two gloo ranks on the card, lr {lr}, float64: {TR_STEPS} steps "
              f"== one process (losses {[m['loss'] for m in m0]} / "
              f"{[m['loss'] for m in m_ref]}; largest state gap {gap:.3e})")
    launches = [g["launches"] for g in got]
    want_launches = len(TR_LRS) * TR_STEPS
    if launches != [want_launches] * 2:
        raise AssertionError(f"two ranks: K1 launches {launches}")
    print(f"rank 0: {results[0][0].strip()}")
    return sum(launches)


def dp_graph_epoch(label, step, make_state, host, b):
    """The DP graph epoch on the data group (a one-rank NCCL group): the
    dataset ``host`` as a DeviceCachedDataset sharded over it; the
    per-step DP epoch over the trainer's host loader (this rank's
    batch_iterator slices) against the graph epoch (make_epoch_scan with
    the sharding: each step assembles its batch with sharded_batch's
    all-reduces) from the same weights (``make_state()``) and order, bit
    for bit; then the graph checked and timed (graph_replays: no host sync
    in a replay, K1 once a replay). Returns (the replays made, timings and
    the batch assembly's bytes a step)."""
    group = mesh.data_group()
    ds = DeviceCachedDataset(host, "cuda", sharding=group)
    eager = make_capturable(make_state())
    loader = prefetch_to_device(batch_iterator(
        host, b, True, 0, mesh.data_rank(), mesh.data_size()), "cuda")
    eager, me = train_cli.run_epoch(step, eager, loader, True)
    graph = make_state()
    scan = make_epoch_scan(step, True, group)
    graph, mg = captured_k1(f"{label} epoch", lambda: run_epoch_scan(
        scan, graph, ds, b, True, 0))
    steps = len(ds) // b
    if graph.step != eager.step or graph.step != steps:
        raise AssertionError(f"{label} graph epoch: step {graph.step}")
    gaps = state_gaps(eager, graph)
    if any(gaps.values()) or me != mg:
        raise AssertionError(f"{label}: the graph epoch is not bit-identical "
                             "to the per-step DP epoch (largest state gap "
                             f"{max(gaps.values()):.3e}, metrics {mg} vs {me})")
    print(f"{label}: graph epoch vs per-step epoch: bit-identical")
    with Collectives() as coll:
        sharded_batch(ds.arrays, one_step_order(b)[0], group)
    gather = coll.nbytes["all_reduce"]
    ms, host_ms, r = graph_replays(label, scan, graph, ds, b)
    print(f"{label} graph step: batch assembly {len(coll.log)} all-reduces "
          f"of {gather} bytes a step")
    return steps + r, {"dp_graph_step_ms": ms, "dp_graph_step_host_ms": host_ms,
                       "dp_gather_bytes_per_step": gather}


def dp_phase(graph_step_ms):
    """Data parallelism on the one card: (a) at TrainConfig's segmentation
    width, the DP step on a one-rank NCCL data group against the step
    without a group (dp_step_check: float64 and float32, collectives,
    bytes, K1), then 5 timed steps without a group beside 5 timed DP steps
    with the stage split (timed_train), and the DP graph epoch on a
    sharded DeviceCachedDataset (dp_graph_epoch), its replay beside the
    trainer-extras phase's graph step (``graph_step_ms``, this call); (c)
    the multiscale and PointNet DP steps against their steps, and
    DP_TIMED timed DP steps each; (b)
    two gloo ranks on the card against one process
    (two_rank_gloo_check). Returns (K1 launches on this path: the
    wrapper's count, the graph's replays and the two workers' launches;
    timings)."""
    t0 = time.perf_counter()
    for kernel in KERNELS:
        kernel.launches = 0
    points, labels = train_batch()
    seg_step, _ = make_ndt_seg_step(TRAIN_M, C, "probe")

    def seg_state(**kw):
        return create_train_state(C, F, lambda _: TRAIN_LR, **kw)

    ms_points = torch.from_numpy(make_batch(MS_B, N, seed=1)).cuda()
    ms_labels = labels[:MS_B]
    ms_step, _ = make_multiscale_seg_step(MS_FINE, MS_COARSE, C, "probe")

    def ms_state(**kw):
        return create_train_state(C, MS_F, lambda _: TRAIN_LR,
                                  model=NDTNetPPSegmentation, fine_res=MS_FINE,
                                  coarse_res=MS_COARSE, **kw)

    ms_preps = [("fine prep", MS_FINE, ms_labels),
                ("coarse prep", MS_COARSE, ms_labels)]
    pn_pts, pn_labels = pointnet_batch(B, PN_N, seed=3)
    pn_batch = (torch.from_numpy(pn_pts).cuda(), torch.from_numpy(pn_labels).cuda())
    pn_step, _ = make_pointnet_seg_step(C)

    def pn_state(**kw):
        return create_train_state(C, F, lambda _: TRAIN_LR,
                                  model=PointNetSegmentation, **kw)

    times = {}
    for model, step, make_state, batch, k1, rows in (
            ("segmentation", seg_step, seg_state, (points, labels), 1,
             B * TRAIN_M),
            ("multiscale", ms_step, ms_state, (ms_points, ms_labels), 2,
             MS_B * MS_FINE),
            ("pointnet", pn_step, pn_state, pn_batch, 0, B * PN_N)):
        times["DP " + model] = dp_step_check(
            "DP " + model, step, make_state, batch, k1, rows,
            DP32_GRAD_TOL[model])
    preps = [("preprocessing", TRAIN_M, labels)]

    def timed_with_profile(label, key):
        state = seg_state()
        times[key], _ = timed_train(label, seg_step, state, (points, labels),
                                    1, preps)
        n, busy, wall, _ = device_share(lambda: seg_step(state, points, labels))
        times[key + "_kernels"] = n
        print(f"{label} profile: {n} kernels, device busy {busy:.3f} ms of "
              f"{wall:.3f} ms (idle {1 - busy / wall:.1%})")

    timed_with_profile("train (no group)", "step_ms")
    mesh.make_data_group("cuda")
    try:
        timed_with_profile("DP train (one-rank NCCL)", "dp_step_ms")
        host = CachedDataset(make_dataset(C, N, synthetic_length=EXTRAS_CLOUDS,
                                          seed=0, int_labels=True))
        replays, more = dp_graph_epoch("DP segmentation", seg_step, seg_state,
                                       host, B)
        times.update(more, graph_step_ms=graph_step_ms)
        times["dp_multiscale_step_ms"], _ = timed_train(
            "DP multiscale (one-rank NCCL)", ms_step, ms_state(),
            (ms_points, ms_labels), 2, ms_preps, steps=DP_TIMED)
        times["dp_pointnet_step_ms"], _ = timed_train(
            "DP pointnet (one-rank NCCL)", pn_step, pn_state(), pn_batch, 0, [],
            steps=DP_TIMED)
    finally:
        mesh.release_group()
    print(f"DP graph step {times['dp_graph_step_ms']:.3f} ms beside the "
          f"graph step without a group {graph_step_ms:.3f} ms (trainer-extras "
          "phase, this call)")
    workers = two_rank_gloo_check()
    eager = sm.fused_moments_sorted.launches
    launches = eager + replays + workers
    print(f"dp: K1 {launches} launches: {eager} eager (counted by its wrapper) "
          f"+ {replays} graph replays of one captured K1 call each + {workers} "
          f"in the two gloo ranks; phase took {time.perf_counter() - t0:.1f} s")
    return launches, times


# ---- the tools: the frame stream, viz, seg_viz, export, the search ----

TOOLS_OUT = "build/chip_smoke_tools"
STREAM_FRAMES = 16                    # tools/stream.py's default
STREAM_RESEARCH = 8                   # --research_every: frames 0 and 8 search
VIZ_N, VIZ_M, VIZ_M1 = 90000, 2080, 1000  # the reference's Hz protocol
VIZ_REPEATS = 3                       # tools/viz.py's default


def quiet(main, argv):
    """A tool's ``main(argv)`` in this process with its stdout and stderr
    kept. Returns (what main returned, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = main(argv)
    return result, out.getvalue(), err.getvalue()


def stream_card_vs_cpu(n_frames=4, n_points=8192, m=256):
    """``tools.stream`` with --mode fixed and the reference search (exact
    on both devices) on the card and on the CPU: the same modes, kept
    counts and voxel sizes frame by frame. Returns the card's frames."""
    runs = {}
    for dev in ("cuda", "cpu"):
        (_, frames), _, _ = quiet(stream_cli.main, [
            "--device", dev, "--n_frames", str(n_frames), "--n_points",
            str(n_points), "--n_desired_nds", str(m), "--mode", "fixed",
            "--search", "reference", "--research_every", "2"])
        runs[dev] = [(f["mode"], f["valid"], f["voxel_size"]) for f in frames]
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError(f"stream card {runs['cuda']} != CPU {runs['cpu']}")
    return runs["cuda"]


def export_round_trip(ckpt, n_classes, feature_dim, points, m, out):
    """``tools.export`` of the segmentation checkpoint ``ckpt`` on the
    card, the written state dict mapped back by ``torch_weights`` into a
    fresh model on the card: its logits on one request (``points``
    preprocessed to m NDs) bit-identical to the checkpoint's model's.
    Returns the written state dict."""
    tree, _, _ = quiet(export_cli.main, [
        "--checkpoint", ckpt, "--n_classes", str(n_classes), "--feature_dim",
        str(feature_dim), "--out", out])
    if set(torch.load(out, weights_only=True)) != set(tree):
        raise AssertionError("export: the written file is not the state dict")
    original = create_train_state(n_classes, feature_dim,
                                  make_lr_schedule(1e-3, 1))
    train_state.restore_checkpoint(original, ckpt)
    fresh = map_ndtnet_segmentation(tree, NDTNetSegmentation(
        num_classes=n_classes, feature_dim=feature_dim))
    pcl, covs, _, _, _ = ndt_preprocessing_with_state(m, points, None,
                                                      n_classes, search="probe")
    with torch.no_grad():
        a = original.model.eval()(pcl, covs, return_logits=True)
        b = fresh.eval()(pcl, covs, return_logits=True)
    if not torch.equal(a, b):
        raise AssertionError(f"export: reloaded logits differ by "
                             f"{float((a - b).abs().max())}")
    return tree


def steady_frame(points, mode, size, model):
    """One steady frame of ``mode`` as tools/stream.py runs it: (the host
    syncs of the downsample, the num_valid readback, the model and its
    argmax readback; device_share of the timed part, the downsample and
    the readback)."""
    def timed_part():
        out, _ = stream_cli.downsample_frame(points, M, mode, size, "probe")
        int(out[4].num_valid[0])
        return out

    def frame():
        out = timed_part()
        stream_cli.classify(model, out[0], out[1])

    return count_syncs(frame), device_share(timed_part)


def tools_phase():
    """The tools at full width on the card: a seed-0 segmentation
    checkpoint (C classes, feature_dim F) written by save_checkpoint; the
    frame stream (STREAM_FRAMES frames of N points -> M NDs, probe search,
    --research_every STREAM_RESEARCH) in warm and in fixed mode with the
    checkpoint's model, one K1 launch a frame, every frame in band, the
    host syncs of a steady frame; viz (VIZ_N points -> VIZ_M NDs, 29
    slots, reference search, --target1 VIZ_M1, --trace); seg_viz (N ->
    2080 at feature_dim F, the checkpoint's model); export of the
    checkpoint reloaded through torch_weights (bit-identical logits on one
    request); hyperparameter_search, 2 trials x 1 epoch at its defaults.
    K1 is held against its plain version on every shape these paths gave
    it. point_histogram (no card work) and parity_train (the reference's
    model code is not in the repository) stay off the card: the CPU tests
    run them. Returns (K1 launches of the paths, K1's max_abs_err,
    timings)."""
    t0 = time.perf_counter()
    os.makedirs(TOOLS_OUT, exist_ok=True)
    card_frames = stream_card_vs_cpu()
    print(f"stream card == CPU (fixed, reference search, 4 x 8192 -> 256): "
          f"{[(mode, n) for mode, n, _ in card_frames]}")
    state = create_train_state(C, F, make_lr_schedule(1e-3, 1), seed=0)
    ckpt = train_state.save_checkpoint(state, os.path.join(TOOLS_OUT, "ckpt"))
    k1 = sm.fused_moments_sorted
    for kernel in KERNELS:
        kernel.launches = 0
    times, launches = {}, 0
    with K1Recorder() as rec:
        for mode in ("warm", "fixed"):
            before = k1.launches
            (stats, frames), _, err = quiet(stream_cli.main, [
                "--mode", mode, "--n_frames", str(STREAM_FRAMES),
                "--n_points", str(N), "--n_desired_nds", str(M),
                "--research_every", str(STREAM_RESEARCH), "--checkpoint",
                ckpt])
            n = k1.launches - before
            launches += n
            counts = [f["valid"] for f in frames]
            searched = [i for i, f in enumerate(frames) if f["mode"] == "search"]
            # the forced searches, and in fixed mode one after each frame
            # that left the band (warm mode heals within the frame)
            want = sorted({0, STREAM_RESEARCH} | {
                i + 1 for i, f in enumerate(frames[:-1])
                if mode == "fixed" and not f["in_band"]})
            out_of_band = [i for i, f in enumerate(frames) if not f["in_band"]]
            if n != STREAM_FRAMES or len(frames) != STREAM_FRAMES:
                raise AssertionError(f"stream {mode}: {n} K1 launches for "
                                     f"{len(frames)} frames")
            if searched != want or (mode == "warm" and out_of_band):
                raise AssertionError(f"stream {mode}: counts {counts}, "
                                     f"searched frames {searched}\n{err}")
            if f"{C} classes, feature_dim {F}" not in err:
                raise AssertionError(f"stream {mode}: model not restored\n{err}")
            pts = torch.from_numpy(list(stream_cli.synthetic_stream(
                STREAM_FRAMES, N))[-1]).cuda()[None]
            size = torch.tensor([frames[-2]["voxel_size"]], device=pts.device)
            syncs, (kernels, busy, wall, top) = steady_frame(
                pts, mode, size, state.model.eval())
            times[f"stream_{mode}"] = {**stats, "host_syncs_per_frame": syncs,
                                       "kernels_per_frame": kernels,
                                       "device_busy_ms": busy,
                                       "profiled_ms": wall}
            print(f"stream --mode {mode} ({STREAM_FRAMES} x {N} -> {M}, "
                  f"probe, C {C}, feature_dim {F}): steady "
                  f"{stats['steady_ms_per_frame']} ms a frame "
                  f"({stats['steady_hz']} Hz), mean "
                  f"{stats['mean_ms_per_frame']} ms; {syncs} host syncs a "
                  f"steady frame (downsample, readbacks, model); {n} K1 "
                  f"launches; counts {counts}, out of [{M}, {int(1.2 * M)}]: "
                  f"frames {out_of_band or 'none'}; searched frames {searched}")
            print(f"stream --mode {mode} steady frame profile (downsample + "
                  f"readback): {kernels} kernels, device busy {busy:.3f} ms "
                  f"of {wall:.3f} ms (idle {1 - busy / wall:.1%}); most device "
                  "time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))

        before = k1.launches
        trace = os.path.join(TOOLS_OUT, "viz_trace")
        result, out, _ = quiet(viz_cli.main, [
            "--n_points", str(VIZ_N), "--target", str(VIZ_M), "--target1",
            str(VIZ_M1), "--out_dir", TOOLS_OUT, "--trace", trace])
        n = k1.launches - before
        launches += n
        kept = int(result["downsampled"][3].sum())
        kept1 = int(result["pruned"][3].sum())
        with open(os.path.join(trace, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        if (n, kept, kept1) != (VIZ_REPEATS + 1, VIZ_M, VIZ_M1) or not kernels:
            raise AssertionError(f"viz: {n} K1 launches, {kept} -> {kept1} "
                                 f"NDs, {kernels} kernels traced")
        times["viz"] = {"downsample_hz": 1 / result["downsample_s"],
                        "prune_hz": 1 / result["prune_s"]}
        print(f"viz ({VIZ_N} -> {VIZ_M} NDs, {C + 1} slots, reference search, "
              f"prune to {VIZ_M1}): " + " ".join(out.split("\n")[:1])
              + f"; {1 / result['downsample_s']:.2f} Hz downsample, "
              f"{1 / result['prune_s']:.2f} Hz prune; {n} K1 launches "
              f"(warm-up + {VIZ_REPEATS}); trace {kernels} kernel events")

        before = k1.launches
        (_, pred, kept), _, _ = quiet(seg_viz_cli.main, [
            "--model_path", ckpt, "--n_samples", str(N), "--n_desired_nds",
            str(TRAIN_M), "--n_classes", str(C), "--feature_dim", str(F),
            "--out", os.path.join(TOOLS_OUT, "seg_viz.ply")])
        n = k1.launches - before
        launches += n
        if (n, int(kept.sum())) != (1, TRAIN_M) or pred.max() > C:
            raise AssertionError(f"seg_viz: {n} K1 launches, {kept.sum()} NDs")
        print(f"seg_viz ({N} -> {TRAIN_M} NDs, feature_dim {F}): "
              f"{np.bincount(pred[kept], minlength=C + 1).nonzero()[0].size} "
              "classes predicted, one K1 launch")

        before = k1.launches
        export_round_trip(ckpt, C, F, torch.from_numpy(
            make_batch(B, N, seed=4)).cuda(), M,
            os.path.join(TOOLS_OUT, "export", "ndtnet_seg.pt"))
        n = k1.launches - before
        launches += n
        print(f"export: {len(os.listdir(os.path.join(TOOLS_OUT, 'export')))} "
              f"files, reloaded through torch_weights on the card: logits "
              f"bit-identical on one request ({B} x {N} -> {M}); {n} K1 launch")

        before = k1.launches
        t1 = time.perf_counter()
        (loss, params), out, err = quiet(hps_cli.main, ["--n_trials", "2",
                                                        "--epochs", "1"])
        n = k1.launches - before
        launches += n
        steps = sum(32 // p["batch_size"]
                    for p in hps_cli.random_trials(0, 2))
        if n != steps or not math.isfinite(loss) or "random search" not in err:
            raise AssertionError(f"hyperparameter_search: {n} K1 launches for "
                                 f"{steps} steps, loss {loss}\n{out}{err}")
        print(f"hyperparameter_search (2 trials x 1 epoch, its defaults): "
              f"best loss {loss:.6g} {params}; {n} K1 launches ({steps} "
              f"steps); {time.perf_counter() - t1:.1f} s")
    err_max = rec.check("tools")
    print(f"tools: K1 {launches} launches; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, err_max, times



# ---- the multi-device dry run and the measurement scripts ----

SEED_ARGS = ["--clouds", "4"]          # the seed scripts' clouds, card and CPU
DP_ALL_REDUCES, DP_BYTES_RATIO = 66, 1.0069  # the full-width DP step (PERF.md)


class K3Recorder:
    """Keeps, while active, the inputs of the first K3 launch of each
    shape (points, table rows, tag columns) that the point-sharded path
    makes, so that check_tags can hold K3 on the data a path gave it."""

    def __enter__(self):
        self.inputs = {}
        self.saved = ps.segment_tags_sorted

        def k3(seg, tags, k):
            self.inputs.setdefault((tuple(seg.shape), k, len(tags)),
                                   (seg, list(tags), k))
            return self.saved(seg, tags, k)

        ps.segment_tags_sorted = k3
        return self

    def __exit__(self, *exc):
        ps.segment_tags_sorted = self.saved

    def check(self, label):
        if not self.inputs:
            raise AssertionError(f"{label}: no K3 launch recorded")
        for (shape, k, t), (seg, tags, _) in self.inputs.items():
            check_tags(seg, tags, f"{label} ([{shape[0]}] -> {k} rows, {t} "
                       "tags)", k)


def multichip_phase():
    """``dryrun_multichip(1)`` on the card (a one-rank NCCL group, in this
    process): the JAX entry's line, its checks, and the K1 and K3
    launches of its path (one K1 each: the single-process steps in
    float64, float32 and the ``JITTERS`` float32 steps of the rounding
    band, and the DP steps in float64 and float32; the multiscale step
    two; the point-sharded moments one K1 and one K3), each kernel held against its plain version on every shape
    the path gave it; ``dryrun_multichip(device_count)`` where the machine
    has more cards. Returns (K1 launches, K3 launches, K1's
    max_abs_err)."""
    t0 = time.perf_counter()
    for kernel in KERNELS:
        kernel.launches = 0
    with K1Recorder() as r1, K3Recorder() as r3:
        out = dryrun_multichip(1)
    k1, k3 = sm.fused_moments_sorted.launches, sm.segment_tags_sorted.launches
    if (k1, k3) != (7 + JITTERS, 1) or out["launches"] != [
            {"fused_moments_sorted": k1, "segment_tags_sorted": k3}]:
        raise AssertionError(f"dryrun_multichip(1): K1 {k1}, K3 {k3} launches "
                             f"({out['launches']})")
    if out["counts_sum"] != 128 or not math.isfinite(out["multiscale_loss"]):
        raise AssertionError(f"dryrun_multichip(1): {out}")
    print(f"dryrun_multichip(1): K1 {k1}, K3 {k3} launches")
    err = r1.check("multichip")
    r3.check("multichip")
    cards = torch.cuda.device_count()
    if cards > 1:
        more = dryrun_multichip(cards)
        k1 += sum(r["fused_moments_sorted"] for r in more["launches"])
        k3 += sum(r["segment_tags_sorted"] for r in more["launches"])
    else:
        print("dryrun_multichip: one card here, so NCCL across cards is "
              "unmeasured")
    print(f"multichip: phase took {time.perf_counter() - t0:.1f} s")
    return k1, k3, err


# kernel_micro's segment reductions and K1's cost probes at the JAX
# script's defaults: B 16 x N 70000 features of 42 columns, dense ranks over
# K 1209; the probes at untagged, the JAX default and the trainers' slots
MICRO_B, MICRO_N, MICRO_F, MICRO_K = 16, 70000, 42, 1209
PROBE_SLOTS = (0, 1, 29)
PROBE_HEADLINE = 1                    # the JAX script's --slots default
PROBE_SOURCE = "ndtpu_torch/csrc/segment_moments.cu"
# the kernel each kernel_micro mode launches, and how often: one warm-up
# and its default --inner 32 x --iters 3 runs (scripts/_timing.py)
MICRO_KERNELS = {"pallas": sm.segment_sum_sorted, **kernel_micro.MOMENT_KERNELS}
MICRO_RUNS = 1 + 32 * 3


def probe_inputs(seg, slots, k, classes=False):
    """kernel_micro's moments* inputs on the card for the [B, N] ranks
    ``seg`` (numpy): its draws (xt, yt, zt normal from default_rng(2), v
    ones, cls zeros, N_TAGS tag columns xt * 0.5), ``slots`` class slots
    and k rows; with ``classes`` the classes drawn from [0, slots) by
    default_rng(3) instead, so every slot column is summed."""
    x = dict(kernel_micro.probe_inputs(seg, N_TAGS, "cuda"), slots=slots, k=k)
    if classes:
        x["cls"] = torch.from_numpy(np.random.default_rng(3).integers(
            0, max(slots, 1), seg.shape).astype(np.int32)).cuda()
    return x


def run_probe(kernel, x, dtype=torch.float32):
    """``kernel`` (P1, P2, K1 or a plain version) on K1's inputs x, the
    float columns in ``dtype``."""
    f = [x[k].to(dtype) for k in ("xt", "yt", "zt", "v")]
    return kernel(*f, x["cls"], x["seg"], x["k"], x["slots"],
                  tags=[t.to(dtype) for t in x["tags"]])


def poisoned(kernel, x):
    """run_probe(kernel, x) after a NaN tensor of the output's size was
    freed: the caching allocator hands its block to the output, so an entry
    the kernel leaves unwritten shows as NaN."""
    f = sm.N_MOMENTS + x["slots"] + len(x["tags"])
    junk = torch.full(tuple(x["seg"].shape[:-1]) + (x["k"], f), float("nan"),
                      device="cuda")
    del junk
    return run_probe(kernel, x)


def check_probes(x, label):
    """P1 and P2 on the card against their plain versions, and K1 (the
    moments mode) against its: P1's output (on a poisoned block) all zero
    of K1's shape; P2 bit-identical over two launches, its count and class
    columns exact, every entry within P2's f32 summation bound
    (``moment_probes.moments_noflop_error_bound``: (chunk / 128 + blocks +
    10) u sum|terms|) of the plain version in float64, so the rows past 7
    exactly 0; K1 by check_kernel with its tag columns (xt * 0.5, dense)
    held to its bound. Returns (P2's largest absolute difference from its
    f32 plain version, K1's)."""
    shape = tuple(x["seg"].shape[:-1]) + (
        x["k"], sm.N_MOMENTS + x["slots"] + len(x["tags"]))
    empty = poisoned(mp.moments_empty, x)
    torch.cuda.synchronize()
    if tuple(empty.shape) != shape or bool(empty.ne(0).any()):
        raise AssertionError(f"P1 {label}: not zeros of {shape}")
    a = poisoned(mp.moments_noflop, x)
    b = run_probe(mp.moments_noflop, x)
    ref = run_probe(mp.moments_noflop_plain, x)
    ref64 = run_probe(mp.moments_noflop_plain, x, torch.float64)
    bound = run_probe(mp.moments_noflop_error_bound, x)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"P2 {label}: two launches differ")
    if tuple(a.shape) != shape:
        raise AssertionError(f"P2 {label}: shape {tuple(a.shape)} != {shape}")
    exact = [0] + list(range(13, 13 + x["slots"]))
    if not torch.equal(a[..., exact], ref[..., exact]):
        raise AssertionError(f"P2 {label}: count/class columns differ")
    excess = (a.double() - ref64).abs() - bound
    if not bool((excess <= 0).all()):  # NaN fails too
        raise AssertionError(f"P2 {label}: off by {float(excess.max())} "
                             "beyond its f32 summation bound")
    p2_err = float((a - ref).abs().max())
    print(f"P2 {label}: ok, max_abs_err {p2_err:.3e}; P1: zeros")
    return p2_err, check_kernel(x, f"{label} (moments mode)")


def probe_bound(x, reads):
    """A probe's bound at x: ``reads`` (P2: every point's columns; P1:
    nothing) and the output written once. P2's operations: the 6
    products, F sums and the slot compares a point."""
    n_points = x["seg"].numel()
    f = sm.N_MOMENTS + x["slots"] + len(x["tags"])
    batch = n_points // x["seg"].shape[-1]
    cols_in = sm.staged_columns(x["slots"], len(x["tags"]))
    return bound(n_points if reads else 0, 4 * cols_in,
                 4 * batch * x["k"] * f,
                 n_points * (6 + f + x["slots"]) if reads else 0)


def probe_split(x):
    """P1, P2 and K1 timed at x (times_ms: in turns, the L2 overwritten
    before each launch) with P1's and P2's plain versions,
    bounds and read floors (P1: ``torch.zeros`` of its output; P2:
    ``torch.sum`` of each of its columns timed as the kernels, and as many
    bytes in one buffer) and K1's bound and read floor. Returns {"moments_empty": timing keys,
    "moments_noflop": ..., "k1": {"ms", "bound_ms", "read_floor_ms"}}."""
    shape = tuple(x["seg"].shape[:-1]) + (
        x["k"], sm.N_MOMENTS + x["slots"] + len(x["tags"]))
    cols = [x["seg"], x["xt"], x["yt"], x["zt"], x["v"], *x["tags"]]
    cols += [x["cls"]] if x["slots"] else []
    kernel_ms = times_ms({
        "moments_empty": lambda: run_probe(mp.moments_empty, x),
        "moments_noflop": lambda: run_probe(mp.moments_noflop, x),
        "k1": lambda: run_kernel(x)})
    zeros_ms = time_ms(lambda: torch.zeros(shape, device="cuda"))
    out = {}
    for kernel, plain, reads in ((mp.moments_empty, mp.moments_empty_plain,
                                  False),
                                 (mp.moments_noflop, mp.moments_noflop_plain,
                                  True)):
        bound_ms, bound_by, moved = probe_bound(x, reads)
        t = {"ms": kernel_ms[kernel.__name__],
             "plain_ms": time_ms(lambda: run_probe(plain, x)),
             "bound_ms": bound_ms, "bound_by": bound_by}
        if reads:
            t["read_floor_ms"] = read_floor_ms(moved)
            t["column_sums_ms"] = time_ms(lambda: [c.sum() for c in cols])
            t["library_ms"] = None
        else:
            t["read_floor_ms"] = t["library_ms"] = zeros_ms
        out[kernel.__name__] = t
    k1_bound, _, k1_moved = k1_bound_ms(x)
    out["k1"] = {"ms": kernel_ms["k1"], "bound_ms": k1_bound,
                 "read_floor_ms": read_floor_ms(k1_moved)}
    return out


def probes_phase():
    """K2 held to its plain version on the pallas mode's inputs (check_sum:
    kernel_micro's [16, 70000, 42] features, dense ranks over K 1209); K1's
    cost split at that shape (3 tag columns) at each of PROBE_SLOTS: P1,
    P2 and K1 checked (check_probes) and timed (probe_split), and the three
    figures printed: empty, noflop - empty, moments - noflop, beside K1's
    bound and read floor. Returns (the largest P2, K1 and K2 max_abs_err,
    {slots: probe_split})."""
    _, feats, seg = kernel_micro.segment_inputs(MICRO_B, MICRO_N, MICRO_F,
                                                MICRO_K)
    k2_err = check_sum(torch.from_numpy(feats).cuda(),
                       torch.from_numpy(seg).cuda(),
                       f"pallas mode [{MICRO_B}, {MICRO_N}, {MICRO_F}] -> "
                       f"{MICRO_K}", MICRO_K)
    del feats
    p2_err = k1_err = 0.0
    split = {}
    for slots in PROBE_SLOTS:
        x = probe_inputs(seg, slots, MICRO_K)
        errs = check_probes(x, f"canonical, slots={slots}")
        p2_err, k1_err = max(p2_err, errs[0]), max(k1_err, errs[1])
        t = split[slots] = probe_split(x)
        empty = t["moments_empty"]["ms"]
        noflop = t["moments_noflop"]["ms"]
        print(f"K1 split, slots={slots} ([{MICRO_B}, {MICRO_N}] -> {MICRO_K} "
              f"rows, {N_TAGS} tags): empty {empty:.4f} ms, noflop - empty "
              f"{noflop - empty:.4f} ms, moments - noflop "
              f"{t['k1']['ms'] - noflop:.4f} ms (moments {t['k1']['ms']:.4f}); "
              f"K1 bound {t['k1']['bound_ms']:.4f} ms, read floor "
              f"{t['k1']['read_floor_ms']:.4f} ms; P2 plain "
              f"{t['moments_noflop']['plain_ms']:.4f}, column sums "
              f"{t['moments_noflop']['column_sums_ms']:.4f} ms, P1 zeros "
              f"{t['moments_empty']['library_ms']:.4f} ms")
    return p2_err, k1_err, k2_err, split


def probe_entries(p2_err, split, launches):
    """The kernels-line entries of P1 and P2: the timing keys at
    PROBE_HEADLINE slots, every slots value's under "slots"."""
    out = []
    for name, line, err in (("moments_empty", 147, 0.0),
                            ("moments_noflop", 154, p2_err)):
        out.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": f"scripts/kernel_micro.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            **split[PROBE_HEADLINE][name],
            "slots": {str(s): split[s][name] for s in PROBE_SLOTS},
        })
    return out


def micro_modes(lines):
    """Each kernel_micro mode's main at its defaults (the JAX script's), its
    JSON line into ``lines``: K2, K1, P2 and P1 each launched exactly
    MICRO_RUNS times by its mode and by no other mode."""
    for mode in kernel_micro.MODES:
        before = {m: k.launches for m, k in MICRO_KERNELS.items()}
        lines[f"micro_{mode}"] = kernel_micro.main(["--mode", mode])
        got = {m: k.launches - before[m] for m, k in MICRO_KERNELS.items()}
        want = {m: MICRO_RUNS if m == mode else 0 for m in MICRO_KERNELS}
        if got != want:
            raise AssertionError(f"kernel_micro {mode}: launches {got}, "
                                 f"expected {want}")


def card_vs_cpu_counts(main, argv):
    """A counting script's JSON on the card and on the CPU, equal but for
    the device's name (the counts are integers of occupancy). Returns
    the card's."""
    card = main(argv)
    cpu = main(argv + ["--device", "cpu"])
    same = {k: v for k, v in card.items() if k != "device"}
    if same != {k: v for k, v in cpu.items() if k != "device"}:
        raise AssertionError(f"{main.__module__}: card {card} != CPU {cpu}")
    return card


def scripts_phase():
    """Each measurement script's main on the card at its full width, each
    JSON line printed: stage_timing at the canonical batch (16 x 70000 ->
    1000, 29 class slots), the training batch's M 2080 and the giant cloud
    (1,048,576 -> 2080 on a one-rank NCCL group); model_timing, flat and
    fold, in f32 and bf16; every kernel_micro mode; the five prep_micro
    modes; seed_hit_rate and probe_seed_validate on 4 clouds of
    each distribution, card == CPU; collectives at one NCCL rank (the 66
    all-reduces and 1.0069 x the parameter bytes of the dp phase's
    step). K1 and K3 are held against their plain versions on the shapes
    these paths gave them; every time must be finite and positive.
    kernel_micro's modes each launch their kernel (K2 pallas, K1 moments,
    P2 moments_noflop, P1 moments_empty) MICRO_RUNS times (micro_modes);
    then K2 at the pallas mode's inputs and K1's cost split (probes_phase).
    Returns (K1, K3, K2 launches, K1's and K2's max_abs_err, the P1 and P2
    entries of the kernels line)."""
    t0 = time.perf_counter()
    for kernel in KERNELS + tuple(MICRO_KERNELS.values()):
        kernel.launches = 0
    lines = {}
    with K1Recorder() as r1, K3Recorder() as r3:
        lines["stage_canonical"] = stage_timing.main([])
        lines["stage_training"] = stage_timing.main(["--n_desired_nds",
                                                     str(TRAIN_M)])
        lines["stage_giant"] = stage_timing.main(["--giant"])
        card_vs_cpu_counts(seed_hit_rate.main, SEED_ARGS)
        card_vs_cpu_counts(probe_seed_validate.main, SEED_ARGS)
        dp, giant = collectives_script.main([])
    reduces = dp["collectives"].get("all_reduce", {})
    ratio = reduces.get("bytes", 0) / dp["param_bytes"]
    if (set(dp["collectives"]) != {"all_reduce"}
            or reduces["count"] != DP_ALL_REDUCES
            or round(ratio, 4) != DP_BYTES_RATIO
            or dp["gradient_allreduce_bytes"] != dp["param_bytes"]):
        raise AssertionError(f"collectives: {dp}")
    if not giant["converged"] or giant["counts_sum"] != giant["points"]:
        raise AssertionError(f"collectives: {giant}")
    print(f"collectives (one NCCL rank): {reduces['count']} all-reduces, "
          f"{ratio:.4f} x the parameter bytes, as the dp phase's step")
    for dtype in ("f32", "bf16"):
        lines[f"model_{dtype}"] = model_timing.main(
            ["--variants", "flat,fold", "--dtype", dtype, "--inner", "20"])
    micro_modes(lines)
    for mode in prep_micro.MODES:
        lines[f"prep_{mode}"] = prep_micro.main(["--mode", mode])
    k1, k3 = sm.fused_moments_sorted.launches, sm.segment_tags_sorted.launches
    k2 = sm.segment_sum_sorted.launches
    launches = {k.__name__: k.launches for k in (mp.moments_empty,
                                                 mp.moments_noflop)}
    err = r1.check("scripts")
    r3.check("scripts")
    for name, line in lines.items():
        keys = (stage_timing.STAGES if name.startswith("stage") else
                model_timing.STAGES + tuple(f"{p}_{v}" for p in (
                    "backbone", "head") for v in ("flat", "fold"))
                if name.startswith("model") else ("ms_per_batch",))
        for key in keys:
            if not (math.isfinite(line[key]) and line[key] > 0):
                raise AssertionError(f"{name}: {key} = {line[key]!r}")
    p2_err, k1_err, k2_err, split = probes_phase()
    print(f"scripts: K1 {k1}, K3 {k3}, K2 {k2}, P1 "
          f"{launches['moments_empty']}, P2 {launches['moments_noflop']} "
          f"launches; phase took {time.perf_counter() - t0:.1f} s")
    return (k1, k3, k2, max(err, k1_err), k2_err,
            probe_entries(p2_err, split, launches))


# ---- the bf16x3 branch of K1 and K2, and the sampler's A/B modes ----

# K1's and K2's timed shapes (TIMED's labels); K2 also at the pallas mode's
BF16X3_K1_SHAPES = ("canonical", "giant moment pass", "training batch",
                    "multiscale fine batch")
BF16X3_K2_SHAPES = ("giant", "canonical batch F=41")
BF16X3_KERNELS = (sm.fused_moments_sorted_bf16x3, sm.segment_sum_sorted_bf16x3)
AB_RUNS = 5                           # timed requests and steps a mode, in turns
# the JAX package's bit-identical switches (NDTPU_KL_INV is read by the
# gather mode only, as in JAX)
MODES = (("NDTPU_EMIT=payload", {"NDTPU_EMIT": "payload"}),
         ("NDTPU_KL_MODE=gather", {"NDTPU_KL_MODE": "gather"}),
         ("NDTPU_KL_MODE=gather NDTPU_KL_INV=argsort",
          {"NDTPU_KL_MODE": "gather", "NDTPU_KL_INV": "argsort"}))


@contextlib.contextmanager
def environ(values):
    """The variables of ``values`` set inside (None: unset), each restored
    after, so that no later phase sees them."""
    saved = {k: os.environ.get(k) for k in values}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(values)
    try:
        yield
    finally:
        put(saved)


def bf16x3():
    return environ({sm.PRECISION_VAR: "bf16x3"})


def bf16x3_share(a, f32, f32_bound):
    """The largest |a - f32| over twice the f32 kernel's bound (0 where
    both are 0): how much of the f32 kernel's own tolerance the branch's
    difference from it takes."""
    d = (a.double() - f32.double()).abs()
    return float(torch.where(d > 0, d / (2 * f32_bound), 0.0).max())


def check_k1_bf16x3(x, label):
    """K1's bf16x3 kernel on the card at x: two launches bit-identical;
    the count, class and sparse tag columns (``sparse_tag_columns``) equal
    to the bf16x3 plain version bit for bit; every entry within
    ``fused_moments_bf16x3_error_bound`` of the plain version in float64,
    and within that bound plus twice the f32 kernel's
    (``fused_moments_error_bound``) of the f32 kernel's output. Returns
    (the largest difference from the bf16x3 plain version, the share of
    the f32 kernel's tolerance the difference from it takes)."""
    a = run_probe(sm.fused_moments_sorted_bf16x3, x)
    b = run_probe(sm.fused_moments_sorted_bf16x3, x)
    ref = run_probe(sm.fused_moments_sorted_bf16x3_plain, x)
    ref64 = run_probe(sm.fused_moments_sorted_plain, x, torch.float64)
    bound = run_probe(sm.fused_moments_bf16x3_error_bound, x)
    f32 = run_probe(sm.fused_moments_sorted, x)
    f32_bound = k1_error_bound(x)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"k1-bf16x3 {label}: two launches differ")
    if a.shape != ref.shape:
        raise AssertionError(f"k1-bf16x3 {label}: shape {tuple(a.shape)}")
    sparse = sparse_tag_columns(x)
    exact = [0] + list(range(13, 13 + x["slots"])) + sparse
    if not torch.equal(a[..., exact], ref[..., exact]):
        raise AssertionError(f"k1-bf16x3 {label}: counts/histogram/tags "
                             "differ from the bf16x3 plain version")
    if not bool(((a.double() - ref64).abs() <= bound).all()):
        raise AssertionError(f"k1-bf16x3 {label}: beyond its bound")
    if not bool(((a.double() - f32.double()).abs() <= bound + 2 * f32_bound).all()):
        raise AssertionError(f"k1-bf16x3 {label}: beyond the bounds of the "
                             "f32 kernel's output")
    err = float((a - ref).abs().max())
    share = bf16x3_share(a, f32, f32_bound)
    print(f"k1-bf16x3 {label}: ok, max_abs_err {err:.3e}, tags exact "
          f"{len(sparse)}/{len(x['tags'])}, against the f32 kernel "
          f"{share:.3f} of its tolerance")
    return err, share


def check_k2_bf16x3(feats, seg, k, label):
    """K2's bf16x3 kernel on the card: two launches bit-identical, every
    entry within ``bf16x3_error_bound`` of the plain version in float64,
    and within that bound plus twice the f32 kernel's
    (``segment_sum_error_bound``) of the f32 kernel's output. Returns (the
    largest difference from the bf16x3 plain version, the share of the f32
    kernel's tolerance the difference from it takes)."""
    a = sm.segment_sum_sorted_bf16x3(feats, seg, k)
    b = sm.segment_sum_sorted_bf16x3(feats, seg, k)
    ref = sm.segment_sum_sorted_bf16x3_plain(feats, seg, k)
    ref64 = sm.segment_sum_sorted_plain(feats.double(), seg, k)
    bound = sm.bf16x3_error_bound(feats, seg, k)
    f32 = sm.segment_sum_sorted(feats, seg, k)
    f32_bound = sm.segment_sum_error_bound(feats, seg, k)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"k2-bf16x3 {label}: two launches differ")
    if a.shape != ref.shape:
        raise AssertionError(f"k2-bf16x3 {label}: shape {tuple(a.shape)}")
    if not bool(((a.double() - ref64).abs() <= bound).all()):
        raise AssertionError(f"k2-bf16x3 {label}: beyond its bound")
    if not bool(((a.double() - f32.double()).abs() <= bound + 2 * f32_bound).all()):
        raise AssertionError(f"k2-bf16x3 {label}: beyond the bounds of the "
                             "f32 kernel's output")
    err = float((a - ref).abs().max())
    share = bf16x3_share(a, f32, f32_bound)
    print(f"k2-bf16x3 {label}: ok, max_abs_err {err:.3e}, against the f32 "
          f"kernel {share:.3f} of its tolerance")
    return err, share


def bf16x3_times(label, f32_fn, fn, plain_fn, library_fn, bound_of):
    """The branch's kernel and the f32 kernel timed in turns (times_ms),
    the bf16x3 plain version, the yardstick (``torch.segment_reduce`` of
    the f32 columns: the same sums to within rounding) and the read floor;
    the bound is the f32 kernel's bytes (the split lives in registers)."""
    t = times_ms({"f32": f32_fn, "bf16x3": fn})
    bound_ms, bound_by, moved = bound_of
    out = {"ms": t["bf16x3"], "f32_ms": t["f32"], "plain_ms": time_ms(plain_fn),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(library_fn), "read_floor_ms": read_floor_ms(moved)}
    print(f"bf16x3 {label}: kernel {out['ms']:.4f} ms, f32 kernel "
          f"{out['f32_ms']:.4f} ms (in turns), plain {out['plain_ms']:.4f} ms, "
          f"segment_reduce {out['library_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({moved / 1e6:.2f} MB by {bound_by}), read floor "
          f"{out['read_floor_ms']:.4f} ms")
    return out


def bf16x3_kernels():
    """K1's branch at K1's four timed shapes, K2's at its two and at the
    pallas mode's [16, 70000, 42]: checked (check_k1_bf16x3,
    check_k2_bf16x3) and timed in turns with the f32 kernel. Returns
    {kernel: (max_abs_err, largest share, {shape: timing keys})}."""
    out = {}
    err = share = 0.0
    shapes = {}
    for label in BF16X3_K1_SHAPES:
        x = TIMED["k1", label]
        e, sh = check_k1_bf16x3(x, label)
        err, share = max(err, e), max(share, sh)
        shapes[label] = bf16x3_times(
            f"k1 {label}", lambda: run_probe(sm.fused_moments_sorted, x),
            lambda: run_probe(sm.fused_moments_sorted_bf16x3, x),
            lambda: run_probe(sm.fused_moments_sorted_bf16x3_plain, x),
            library_call(x), k1_bound_ms(x))
    out["k1"] = (err, share, shapes)
    _, pallas_feats, pallas_seg = kernel_micro.segment_inputs(
        MICRO_B, MICRO_N, MICRO_F, MICRO_K)
    pallas = (torch.from_numpy(pallas_feats).cuda(),
              torch.from_numpy(pallas_seg).cuda(), MICRO_K)
    del pallas_feats
    err = share = 0.0
    shapes = {}
    for label in BF16X3_K2_SHAPES + ("pallas mode",):
        feats, seg, k = (pallas if label == "pallas mode"
                         else TIMED["segment_sum_sorted", label])
        e, sh = check_k2_bf16x3(feats, seg, k, label)
        err, share = max(err, e), max(share, sh)
        kept = int((seg < k).sum())
        width = feats.shape[-1]
        clouds = seg.numel() // seg.shape[-1]
        shapes[label] = bf16x3_times(
            f"k2 {label}", lambda: sm.segment_sum_sorted(feats, seg, k),
            lambda: sm.segment_sum_sorted_bf16x3(feats, seg, k),
            lambda: sm.segment_sum_sorted_bf16x3_plain(feats, seg, k),
            segment_reduce_call(feats, seg, k),
            bound(kept, 4 * width, 4 * clouds * k * width, kept * width))
    out["k2"] = (err, share, shapes)
    return out


@torch.no_grad()
def request_outputs(pipe, points):
    """A serving request as SegmentationPipeline makes it, keeping the
    preprocessing's outputs: (points, covs, labels, mask, state,
    logits)."""
    pcl, covs, labels, mask, state = ndt_preprocessing_with_state(
        M, points, None, C, search="probe")
    return pcl, covs, labels, mask, state, pipe.model(pcl, covs,
                                                      return_logits=True)


def check_prep(out, m, label):
    """Every cloud converged with m NDs, finite points and covariances."""
    pcl, covs, _, mask, state = out[:5]
    if not bool(state.converged.all()):
        raise AssertionError(f"{label}: a cloud did not converge")
    if not bool((mask.sum(-1) == m).all()):
        raise AssertionError(f"{label}: not every cloud kept {m} NDs")
    if not (bool(torch.isfinite(pcl).all()) and bool(torch.isfinite(covs).all())):
        raise AssertionError(f"{label}: non-finite outputs")


def check_against_f32(got, ref, label):
    """A preprocessing under bf16x3 against the same under f32 on the
    card. The search sees counts only, so the state's integers are equal;
    means and covariances agree as the card and the CPU do (the
    tolerances of check_variant_vs_cpu). Where well posed, the KLs are as
    finite as f32's, and equal to 1e-3 the CPU's KL stage on the branch's
    own moments (their difference from f32's is printed: the KL inverts
    the covariance, so it scales the moments' rounding differences by the
    condition number). The kept NDs of the two may differ where rounding
    moves a KL across the prune's cut, in at most KEPT_DIFF_FRAC of them.
    Returns (NDs kept under bf16x3 and not under f32, kept NDs, the
    largest relative KL difference from f32 where well posed)."""
    st, rs = got[4], ref[4]
    for name in ("voxel_size", "num_valid", "counts", "zyx", "lens",
                 "class_hist"):
        if not torch.equal(getattr(st, name), getattr(rs, name)):
            raise AssertionError(f"{label}: {name} differs from f32")
    vs2 = float(st.voxel_size.max()) ** 2
    torch.testing.assert_close(st.means, rs.means, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st.covs, rs.covs, rtol=1e-4,
                               atol=1e-5 * max(1.0, vs2))
    host = ndt.NDTResult(**{f.name: getattr(st, f.name).cpu()
                            for f in dataclasses.fields(ndt.NDTResult)})
    cpu_kl = neighbor_min_kl(host.means, host.covs, host.counts, host.zyx,
                             host.lens)
    rel = 0.0
    for i in range(st.counts.shape[0]):
        ok = well_posed(rs.counts[i].cpu(), rs.zyx[i].cpu(), rs.covs[i].cpu())
        for name, cpu in zip(("min_kl", "max_kl"), cpu_kl):
            a = getattr(host, name)[i][ok]
            r = getattr(rs, name)[i].cpu()[ok]
            if not torch.equal(torch.isinf(a), torch.isinf(r)):
                raise AssertionError(f"{label}: {name} finiteness differs "
                                     "from f32")
            fin = torch.isfinite(a)
            torch.testing.assert_close(a[fin], cpu[i][ok][fin], rtol=1e-3,
                                       atol=1e-3)
            if bool(fin.any()):
                rel = max(rel, float(((a[fin] - r[fin]).abs()
                                      / r[fin].abs().clamp(min=1e-3)).max()))
    diff = kept = 0
    for i in range(got[0].shape[0]):
        mine, theirs = got[0][i][got[3][i]], ref[0][i][ref[3][i]]
        near = torch.cdist(mine.double(), theirs.double()).amin(-1) < 1e-3
        diff += int((~near).sum())
        kept += len(mine)
    if diff > KEPT_DIFF_FRAC * kept:
        raise AssertionError(f"{label}: {diff} of {kept} kept NDs differ from f32")
    return diff, kept, rel


def timed_turns(fns, runs=AB_RUNS):
    """Each of ``fns`` (name -> function returning its outputs) run
    ``runs`` times in turns (forward, then backward order), each between
    two CUDA events after a warm-up. Returns ({name: median ms}, {name:
    the last run's outputs})."""
    for fn in fns.values():
        fn()
    ms = {name: [] for name in fns}
    last = {}
    order = list(fns)
    for i in range(runs):
        for name in (order if i % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            last[name] = fns[name]()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in ms.items()}, last


def bf16x3_paths():
    """The main path under NDTPU_PALLAS_PRECISION=bf16x3 with the bf16x3
    counts zeroed just before and read just after: serving requests (B 16,
    N 70000, M 1000, 28 classes, feature_dim 768, probe search) and eager
    segmentation train steps (the training batch, M 2080, 29 slots), each
    timed in turns with the same under f32 (AB_RUNS each, after a
    warm-up), and kernel_micro's pallas mode (K2). The branch's requests
    and steps are checked against f32 (check_prep, check_against_f32);
    the f32 kernels launch only in the f32 runs. Returns ({kernel:
    launches}, timing and check figures)."""
    pipe = SegmentationPipeline(n_desired=M, num_classes=C, feature_dim=F,
                                device="cuda")
    request = torch.from_numpy(make_batch(B, N, seed=1)).cuda()
    points, labels = train_batch()
    step, _ = make_ndt_seg_step(TRAIN_M, C, "probe")
    states = {name: create_train_state(C, F, lambda _: TRAIN_LR)
              for name in ("f32", "bf16x3")}

    def under(name, fn):
        def run():
            with environ({sm.PRECISION_VAR: None if name == "f32" else "bf16x3"}):
                return fn()
        return run

    def train(name):
        with PrepRecorder(keep=True) as po:
            states[name], m = step(states[name], points, labels)
        return po.outs[0], m

    for kernel in BF16X3_KERNELS:
        kernel.launches = kernel.captured = 0
    f32_k1 = sm.fused_moments_sorted.launches
    req_ms, req = timed_turns({n: under(n, lambda: request_outputs(pipe, request))
                               for n in ("f32", "bf16x3")})
    step_ms, steps = timed_turns({n: under(n, lambda n=n: train(n))
                                  for n in ("f32", "bf16x3")})
    with bf16x3():
        micro = kernel_micro.main(["--mode", "pallas"])
    launches = {k.__name__: k.launches for k in BF16X3_KERNELS}
    runs = 2 * (1 + AB_RUNS)
    if (launches != {"fused_moments_sorted_bf16x3": runs,
                     "segment_sum_sorted_bf16x3": MICRO_RUNS}
            or sm.fused_moments_sorted.launches - f32_k1 != runs
            or any(k.captured for k in BF16X3_KERNELS)):
        raise AssertionError(f"bf16x3 paths: launches {launches}, f32 K1 "
                             f"{sm.fused_moments_sorted.launches - f32_k1}")
    check_prep(req["bf16x3"], M, "bf16x3 request")
    if not bool(torch.isfinite(req["bf16x3"][5]).all()):
        raise AssertionError("bf16x3 request: non-finite logits")
    req_diff = check_against_f32(req["bf16x3"], req["f32"], "bf16x3 request")
    (prep_b, m_b), (prep_f, _) = steps["bf16x3"], steps["f32"]
    check_prep(prep_b, TRAIN_M, "bf16x3 train step")
    loss, acc = float(m_b["loss"]), float(m_b["accuracy"])
    if not (math.isfinite(loss) and 0 <= acc <= 1):
        raise AssertionError(f"bf16x3 train step: loss {loss}, accuracy {acc}")
    step_diff = check_against_f32(prep_b, prep_f, "bf16x3 train step")
    print(f"bf16x3 request: {req_ms['bf16x3']:.3f} ms against f32 "
          f"{req_ms['f32']:.3f} ms (median of {AB_RUNS}, in turns); kept NDs "
          f"not kept under f32: {req_diff[0]} of {req_diff[1]}; well-posed "
          f"KLs within {req_diff[2]:.2e} of f32's (relative)")
    print(f"bf16x3 train step: {step_ms['bf16x3']:.3f} ms against f32 "
          f"{step_ms['f32']:.3f} ms; loss {loss:.4f}; kept NDs not kept under "
          f"f32: {step_diff[0]} of {step_diff[1]}; well-posed KLs within "
          f"{step_diff[2]:.2e} of f32's; kernel_micro pallas "
          f"{micro['ms_per_batch']:.4f} ms under bf16x3")
    return launches, {"request_ms": req_ms, "step_ms": step_ms,
                      "request_kept_diff": list(req_diff),
                      "step_kept_diff": list(step_diff),
                      "pallas_mode_ms": micro["ms_per_batch"]}


def modes_phase():
    """One serving request (the bf16x3 paths' pipeline and batch) under
    each of MODES against the default request, timed in turns with it:
    points, covariances, labels, mask, min_kl and max_kl and the logits
    bit-identical. Returns {mode: (default ms, mode ms)}."""
    pipe = SegmentationPipeline(n_desired=M, num_classes=C, feature_dim=F,
                                device="cuda")
    request = torch.from_numpy(make_batch(B, N, seed=1)).cuda()
    out = {}
    for label, values in MODES:
        def run(vals):
            def fn():
                with environ(vals):
                    return request_outputs(pipe, request)
            return fn
        ms, got = timed_turns({"default": run({k: None for k in values}),
                               label: run(values)})
        a, b = got["default"], got[label]
        pairs = list(zip(a[:4], b[:4])) + [(a[4].min_kl, b[4].min_kl),
                                           (a[4].max_kl, b[4].max_kl),
                                           (a[5], b[5])]
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{label}: the request differs from the "
                                 "default's")
        out[label] = (ms["default"], ms[label])
        print(f"mode {label}: bit-identical to the default; {ms[label]:.3f} "
              f"ms against {ms['default']:.3f} ms (median of {AB_RUNS}, in turns)")
    return out


def bf16x3_phase():
    """The bf16x3 branch's kernels (bf16x3_kernels), the main path under
    it (bf16x3_paths), the A/B modes (modes_phase). Returns the kernels
    line's K1-bf16x3 and K2-bf16x3 entries."""
    t0 = time.perf_counter()
    kernels = bf16x3_kernels()
    launches, paths = bf16x3_paths()
    modes = modes_phase()
    entries = []
    for key, name, line, headline in (
            ("k1", "fused_moments_sorted_bf16x3", 253, "canonical"),
            ("k2", "segment_sum_sorted_bf16x3", 81, "giant")):
        err, share, shapes = kernels[key]
        entries.append({
            "name": f"{key.upper()}-bf16x3", "route": "cuda",
            "source": "ndtpu_torch/csrc/segment_moments.cu",
            "replaces": f"ndtpu/ops/pallas/segment_moments.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            **{k: v for k, v in shapes[headline].items()},
            "f32_bound_share": share, "shapes": shapes})
    entries[0]["paths"] = paths
    entries[0]["modes"] = {k: {"default_ms": a, "ms": b}
                           for k, (a, b) in modes.items()}
    print(f"bf16x3: phase took {time.perf_counter() - t0:.1f} s")
    return entries


def main() -> int:
    if sys.argv[1:2] == ["--dp_worker"]:
        return dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    k1, real = k1_phase()
    served = serve_phase()
    # after serving: the requests meet the card as the K1 phase left it
    k2_canonical = k2_batch(real)
    giant_launches, giant_err, giant_times, k3_k2 = giant_phase()
    train_launches, train_err, train_times = train_phase()
    cls_launches = classification_phase()
    ms_launches, ms_err, ms_times = multiscale_phase()
    var_launches, var_err = ndt_variants_phase()
    pn_launches = pointnet_phase()
    carla_launches, carla_err, fps = carla_phase()
    extras_launches, extras_err, extras_times = extras_phase()
    dp_launches, dp_times = dp_phase(extras_times["graph_step_ms"])
    tools_launches, tools_err, tools_times = tools_phase()
    mc_k1, mc_k3, mc_err = multichip_phase()
    sc_k1, sc_k3, sc_k2, sc_err, sc_k2_err, probes = scripts_phase()
    bf16x3_entries = bf16x3_phase()
    # K1's launches on the main paths; its giant-, training- and
    # multiscale-shape times ride along, as K2's canonical-batch times ride
    # along with its giant entry
    k1["launches"] = (served + giant_launches + train_launches + cls_launches
                      + ms_launches + var_launches + pn_launches
                      + carla_launches + extras_launches + dp_launches
                      + tools_launches + mc_k1 + sc_k1)
    k1["max_abs_err"] = max(k1["max_abs_err"], giant_err, train_err, ms_err,
                            var_err, carla_err, extras_err, tools_err, mc_err,
                            sc_err)
    k1["tools"] = tools_times
    k1["graph"] = extras_times
    k1["dp"] = dp_times
    k1["giant"] = giant_times
    k1["train"] = train_times
    k1["multiscale"] = ms_times
    k3_k2[0]["launches"] += mc_k3 + sc_k3
    k2 = k3_k2[1]
    k2["launches"] += sc_k2
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_canonical["max_abs_err"],
                            sc_k2_err)
    k2["batch"] = {k: v for k, v in k2_canonical.items() if k != "max_abs_err"}
    print(json.dumps({"not_a_tpu_kernel": fps}))
    print(json.dumps({"kernels": [k1] + k3_k2 + probes + bf16x3_entries}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
