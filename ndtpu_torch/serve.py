"""The entry points: the serving path, and the multi-device dry run.

``entry`` is the port's counterpart of ``__graft_entry__.entry`` and of
the inference half of bench.py's ``build_pipeline``: a batch of raw
clouds in, per-ND logits out (NDT preprocessing, then
NDTNetSegmentation). On CUDA the preprocessing runs the segment-moments
kernel once per batch.

``dryrun_multichip`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one data-parallel segmentation
train step over n ranks held to a single-process step of the same batch,
a data-parallel NDT-Net++ step, and the point-sharded moments of one
cloud, on tiny shapes. The ranks are processes: NCCL, one card a rank, on
the card; gloo on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.parallel.mesh import run_ranks
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.utils.device import resolve_device
from ndtpu_torch.utils.profiling import span


def init_random_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from a seed, drawn on the CPU so every device gets
    the same model: each Linear weight ~ N(0, 1/fan_in) and zero bias (the
    scale of flax's default lecun_normal), BatchNorm at identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                w = torch.randn(m.weight.shape, generator=g)
                m.weight.copy_(w / m.in_features**0.5)
                m.bias.zero_()
    return model


class SegmentationPipeline:
    """Preprocess a batch of clouds to ``n_desired`` NDs, then segment.

    ``search`` is the voxel-size search of ndt_downsample ("probe" is the
    serving default). ``dtype`` is the model's compute type (bench.py's
    ``build_pipeline(dtype=...)``: bfloat16 runs the model's matmuls on the
    tensor cores); the parameters and the NDT preprocessing stay float32.
    Weights are random from ``seed``; load trained ones with
    ``ndtpu_torch.interop.jax_weights.load_jax_variables(pipeline.model,
    variables)``.
    """

    def __init__(self, n_desired: int = 1000, num_classes: int = 28,
                 feature_dim: int = 768, search: str = "probe",
                 device="cuda", seed: int = 0, dtype=torch.float32):
        self.device = resolve_device(device)
        self.n_desired = n_desired
        self.num_classes = num_classes
        self.search = search
        model = NDTNetSegmentation(num_classes=num_classes,
                                   feature_dim=feature_dim, device=self.device,
                                   dtype=dtype)
        self.model = init_random_(model, seed).eval()

    @torch.no_grad()
    def __call__(self, points):
        """points [B, N, 3] -> (logits [B, n_desired, num_classes + 1] in
        the compute type, out_mask [B, n_desired], NDTResult)."""
        with span("ndtpu.request"):
            with span("ndtpu.h2d"):
                points = torch.as_tensor(points, dtype=torch.float32,
                                         device=self.device)
            pcl, covs, _, mask, state = ndt_preprocessing_with_state(
                self.n_desired, points, None, self.num_classes,
                search=self.search,
            )
            with span("ndtpu.model"):
                logits = self.model(pcl, covs, return_logits=True)
        return logits, mask, state


def entry(canonical: bool = False, device="cuda"):
    """Returns (fn, example_args) with fn(points) -> logits.

    The small shape is B=2, N=4096, M=256, C=8, feature_dim 128; the
    canonical one B=16, N=70000, M=1000, C=28, feature_dim 768. As in the
    JAX entry, the card runs the probe search and the CPU the reference
    bisection."""
    dev = resolve_device(device)
    if canonical:
        b, n, m, c, f = 16, 70000, 1000, 28, 768
    else:
        b, n, m, c, f = 2, 4096, 256, 8, 128
    pipe = SegmentationPipeline(
        m, c, f, search="probe" if dev.type == "cuda" else "reference",
        device=dev,
    )

    def forward(points):
        return pipe(points)[0]

    return forward, (torch.as_tensor(example_cloud(b, n), device=dev),)


DRYRUN_LR = 1e-3  # optax.adam(1e-3) in the JAX entry
DRYRUN_FEATURES = 32
JITTERS = 4  # weight draws that measure the float32 rounding band


def _dryrun_rank(rank: int, n: int, init_method, device_type: str,
                 variables):
    """One rank of ``dryrun_multichip``: the shapes and checks of the JAX
    entry (__graft_entry__.py:69-166). Rank 0 first takes the
    single-process steps on the whole batch (no group yet) and measures
    the float32 rounding band, then every rank joins the data group of
    ``n`` ranks. Raises on a failing check; returns its results."""
    from ndtpu_torch.core import voxel as vx
    from ndtpu_torch.interop.jax_weights import load_jax_variables
    from ndtpu_torch.models import NDTNetPPSegmentation
    from ndtpu_torch.ops import segment_moments as sm
    from ndtpu_torch.parallel import mesh
    from ndtpu_torch.parallel.point_sharded import sharded_segment_moments
    from ndtpu_torch.train.loop import (make_multiscale_seg_step,
                                        make_ndt_seg_step)
    from ndtpu_torch.train.state import create_train_state

    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    kernels = (sm.fused_moments_sorted, sm.segment_tags_sorted)
    before = [k.launches for k in kernels]
    b, n_pts, m, c = 2 * n, 128, 12, 4
    pts = example_cloud(b, n_pts)
    labels = (pts[..., 0] > 0).astype(np.int64) + 1
    points = torch.from_numpy(pts).to(dev)
    gt = torch.from_numpy(np.eye(c + 1, dtype=np.float32)[labels]).to(dev)
    step, _ = make_ndt_seg_step(m, c)

    def seg_loss(dtype, rows, jitter=None):
        """The step's loss on clouds ``rows`` from the seed's (or the given
        variables') weights in ``dtype``, each weight first moved by a
        relative 1e-7 normal draw from seed ``jitter`` if given."""
        state = create_train_state(c, DRYRUN_FEATURES, lambda _: DRYRUN_LR,
                                   device=dev, dtype=dtype, param_dtype=dtype)
        if variables is not None:
            load_jax_variables(state.model, variables)
        if jitter is not None:
            gen = torch.Generator().manual_seed(jitter)
            with torch.no_grad():
                for p in state.model.parameters():
                    r = torch.randn(p.shape, generator=gen, dtype=torch.float64)
                    p.copy_(p.double() * (1 + 1e-7 * r.to(dev)))
        return float(step(state, points[rows], gt[rows])[1]["loss"])

    single = single32 = band = None
    if rank == 0:  # before the group: the single-process arithmetic
        single = seg_loss(torch.float64, slice(None))
        single32 = seg_loss(torch.float32, slice(None))
        band = max(abs(seg_loss(torch.float32, slice(None), k) - single32)
                   for k in range(JITTERS))
    group = mesh.make_data_group(dev, init_method, n, rank)
    try:
        # this rank's block of the global batch, as shard_batch lays it out
        mine = slice(rank * b // n, (rank + 1) * b // n)
        loss = seg_loss(torch.float64, mine)
        loss32 = seg_loss(torch.float32, mine)
        if not (np.isfinite(loss) and np.isfinite(loss32)):
            raise RuntimeError(f"non-finite loss {loss}, {loss32}")
        if single is not None:
            tol = 1e-5 + 1e-5 * abs(single)
            if abs(loss - single) > tol:
                raise RuntimeError(f"data-parallel loss {loss} != "
                                   f"single-process loss {single}")
            if abs(loss32 - single32) > max(tol, band):
                raise RuntimeError(
                    f"float32 data-parallel loss {loss32} != single-process "
                    f"loss {single32} beyond the rounding band {band}")

        fine, coarse = 16, 8
        ms_step, _ = make_multiscale_seg_step(fine, coarse, c)
        ms_state = create_train_state(
            c, DRYRUN_FEATURES, lambda _: DRYRUN_LR, seed=1, device=dev,
            model=NDTNetPPSegmentation, fine_res=fine, coarse_res=coarse)
        ms_loss = float(ms_step(ms_state, points[mine], gt[mine])[1]["loss"])
        if not np.isfinite(ms_loss):
            raise RuntimeError(f"non-finite multiscale loss {ms_loss}")

        # cloud 0's points split over the ranks (the JAX entry's points mesh)
        flat = points[0, :(n_pts // n) * n]
        mask = torch.ones(flat.shape[0], dtype=torch.bool, device=dev)
        mins, maxs = vx.pointcloud_limits(flat)
        size = torch.ones((), device=dev)
        lens, offsets = vx.estimate_voxel_grid(mins, maxs, size)
        out = sharded_segment_moments(
            group, mesh.shard_points(flat, group), mesh.shard_points(mask, group),
            size, lens, offsets, 64)
        counted = int(out["counts"].sum())
        if counted != flat.shape[0]:
            raise RuntimeError(f"point-sharded counts sum to {counted}, not "
                               f"{flat.shape[0]}")
    finally:
        mesh.release_group()
    result = {
        "loss": loss, "single_loss": single,
        "loss_f32": loss32, "single_loss_f32": single32, "band_f32": band,
        "multiscale_loss": ms_loss, "num_valid": int(out["num_valid"]),
        "counts_sum": counted,
        "launches": {k.__name__: k.launches - b0
                     for k, b0 in zip(kernels, before)},
    }
    if rank == 0:
        print(f"dryrun_multichip({n}): float32 DP loss {loss32!r}, "
              f"single-process {single32!r}, rounding band {band!r}; float64 "
              f"DP loss {loss!r}, single-process {single!r}", flush=True)
        print(f"dryrun_multichip({n}): loss={loss32:.4f}, multiscale "
              f"loss={ms_loss:.4f}, point-sharded "
              f"voxels={result['num_valid']} ok", flush=True)
    return result


def dryrun_multichip(n_devices: int, device="cuda", variables=None):
    """One data-parallel train step and the point-sharded moments over
    ``n_devices`` ranks (``__graft_entry__.dryrun_multichip``):

    - the NDT-Net segmentation step (B = 2n clouds of N 128 points, M 12,
      4 classes, feature_dim 32, Adam 1e-3, the fast search) over an
      n-rank data group, each rank holding its block of 2 clouds, in
      float32 as users train and in float64 (the preprocessing stays
      float32 in both). The float64 loss is held within 1e-5 + 1e-5 |loss|
      of a single-process step on the whole batch (rank 0, before the
      group), the JAX entry's check. The float32 loss is held to the
      float32 single-process step within that bound or the rounding band,
      whichever is larger: the band is the largest move of the
      single-process float32 loss when every weight moves by a relative
      1e-7 (a float32 ulp) normal draw, over ``JITTERS`` draws. At these
      shapes the TNets' BatchNorms over 2-4 rows amplify rounding so far
      that the global statistics' arithmetic and the single process's can
      lie further apart than the JAX bound in float32 (on an H100), so
      only the float64 pair can tell a wrong reduction from rounding;
    - the NDT-Net++ step (fine 16, coarse 8) over the group: a finite loss;
    - cloud 0's points split over the ranks, voxel size 1.0, k_max 64
      (``sharded_segment_moments``): the counts sum to the points.

    The ranks are processes (``parallel/mesh.py::run_ranks``): NCCL with
    one card a rank on ``device="cuda"`` (more ranks than cards raises;
    nothing falls back to fewer ranks or to the CPU), gloo with
    ``device="cpu"``. One rank runs in this process. Initial weights
    come from seed 0 (the NDT-Net++ from seed 1), or the segmentation
    model's from ``variables``, a flax variables tree as numpy
    (``load_jax_variables``). Any failing check raises, and a failing
    rank fails the call. Rank 0 prints both losses and the band, then the
    JAX entry's line (its loss the float32 one).

    Returns rank 0's results: loss and single_loss (float64), loss_f32,
    single_loss_f32 and band_f32, multiscale_loss, num_valid, counts_sum,
    and ``launches``, each rank's kernel launches
    ({"fused_moments_sorted": K1, "segment_tags_sorted": K3}; none on the
    CPU)."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1: {n_devices}")
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    results = run_ranks(_dryrun_rank, n_devices, dev.type, variables)
    return {**results[0], "launches": [r["launches"] for r in results]}
