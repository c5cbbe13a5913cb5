"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc (the kernels are built at first use); every
test here skips without a card. This file imports neither jax nor
``ndtpu``, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -q
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from ndtpu_torch.core.ndt import ndt_downsample
from ndtpu_torch.data.loader import DeviceCachedDataset
from ndtpu_torch.models import (
    NDTNetClassification,
    NDTNetPPClassification,
    NDTNetPPSegmentation,
    NDTNetSegmentation,
    PointNetClassification,
    PointNetSegmentation,
)
from ndtpu_torch.ops import segment_moments as sm
from ndtpu_torch.ops.fps import farthest_point_sampling
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel.point_sharded import make_point_sharded_downsample
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.tools.train import run_epoch
from ndtpu_torch.train.loop import (
    WARMUP_STEPS,
    make_epoch_scan,
    make_ndt_seg_step,
    run_epoch_scan,
)
from ndtpu_torch.train.state import create_train_state, make_capturable

from ndtpu_torch.scripts import kernel_micro, probe_seed_validate, seed_hit_rate
from ndtpu_torch.serve import dryrun_multichip

# the card checks shared with chip_smoke.py, at the repo's root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# run lengths just below, at and above the chunk kernels' tiles (256, 512,
# 1024 points) and chunks (512 and up)
EDGE_RUNS = (255, 256, 257, 1, 511, 512, 513, 1023, 1024, 1025, 31, 33)


def layout_ids(layout, b, n, k, rng):
    """[b, n] sorted ids over k segments (ids >= k dropped):
    "random": dense ranks, the last 9 points dropped; "one": one segment
    holds the whole cloud; "singletons": one point a segment; "edges": runs
    of EDGE_RUNS lengths in turn, the ids past k dropped; "gaps": the first
    third of the points on sorted ids with gaps (empty rows between and
    after them), the rest a dropped tail; "long": runs of 3000 points,
    longer than a chunk, the ids past k dropped."""
    seg = np.zeros((b, n), np.int32)
    for i in range(b):
        if layout == "random":
            seg[i, rng.choice(n - 1, size=k - 1, replace=False) + 1] = 1
            seg[i] = np.cumsum(seg[i])
            seg[i, -9:] = k
        elif layout == "singletons":
            seg[i] = np.minimum(np.arange(n), k)
        elif layout == "edges":
            runs = np.resize(np.roll(EDGE_RUNS, i), n)
            seg[i] = np.minimum(np.repeat(np.arange(n), runs)[:n], k)
        elif layout == "gaps":
            kept = n // 3
            seg[i, :kept] = np.sort(rng.integers(0, k - k // 4, kept))
            seg[i, kept:] = k + np.sort(rng.integers(0, 5, n - kept))
        elif layout == "long":
            seg[i] = np.minimum(np.arange(n) // 3000, k)
        else:  # "one"
            seg[i] = 0
    return seg


def inputs(b, n, k, slots, seed, layout="random", n_tags=3):
    """[b, n] ids of the layout, masked coordinates, class tags, n_tags tag
    columns nonzero on each segment's first row."""
    rng = np.random.default_rng(seed)
    seg = layout_ids(layout, b, n, k, rng)
    v = (rng.random((b, n)) > 0.1).astype(np.float32)
    cols = [(rng.normal(size=(b, n)) * v).astype(np.float32) for _ in range(3)]
    cls = rng.integers(0, max(slots, 1), (b, n)).astype(np.int32)
    first = np.ones((b, n), bool)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    tags = [np.where(first, rng.integers(0, 999, (b, n)), 0).astype(np.float32)
            for _ in range(n_tags)]
    return [torch.from_numpy(a) for a in cols + [v, cls, seg]], \
        [torch.from_numpy(a) for a in tags]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,slots,layout,n_tags", [
    (3, 20000, 500, 0, "random", 3), (3, 20000, 500, 29, "random", 3),
    (1, 37, 30, 2, "random", 3), (2, 5000, 1, 0, "random", 3),
    (16, 70000, 1209, 0, "random", 3),       # the canonical request's shape
    (1, 1 << 20, 1, 1, "one", 2),            # one segment, the whole cloud
    (16, 4096, 4000, 0, "singletons", 0),
    (16, 70000, 300, 29, "edges", 8),        # runs across tile/range edges
    (1, 50000, 180, 1, "edges", 2),
    (1, 200000, 3000, 1, "gaps", 3),         # empty rows, long dropped tail
    (16, 20000, 700, 29, "gaps", 8),
])
def test_segment_moments_kernel_matches_plain(cuda, b, n, k, slots, layout,
                                              n_tags):
    args, tags = inputs(b, n, k, slots, seed=n + slots, layout=layout,
                        n_tags=n_tags)
    args = [a.to(cuda) for a in args]
    tags = [t.to(cuda) for t in tags]
    xt, yt, zt, v, cls, seg = args
    cls = cls if slots else None
    before = sm.fused_moments_sorted.launches
    out = sm.fused_moments_sorted(xt, yt, zt, v, cls, seg, k, slots, tags=tags)
    again = sm.fused_moments_sorted(xt, yt, zt, v, cls, seg, k, slots, tags=tags)
    torch.cuda.synchronize()
    assert sm.fused_moments_sorted.launches == before + 2
    assert torch.equal(out, again)  # a fixed summation order
    ref = sm.fused_moments_sorted_plain(xt, yt, zt, v, cls, seg, k, slots,
                                        tags=tags)
    exact = [0] + list(range(13, out.shape[-1]))
    assert torch.equal(out[..., exact], ref[..., exact])
    # sums: within twice the kernel's f32 summation bound of the plain
    # version in float64 (a 5000-row segment sums 157 terms per lane)
    ref64 = sm.fused_moments_sorted_plain(
        xt.double(), yt.double(), zt.double(), v.double(), cls, seg, k, slots,
        tags=[t.double() for t in tags])
    bound = sm.fused_moments_error_bound(xt, yt, zt, v, cls, seg, k, slots,
                                         tags=tags)
    assert bool(((out.double() - ref64).abs() <= 2 * bound).all())
    one = sm.fused_moments_sorted(xt[0], yt[0], zt[0], v[0],
                                  None if cls is None else cls[0], seg[0], k,
                                  slots, tags=[t[0] for t in tags])
    assert torch.equal(one, out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,n_cols,slots,f", [
    (16, 70000, 8, 0, None), (1, 1 << 20, 8, 1, None), (1, 1 << 20, 5, 0, None),
    (3, 20000, 14, 29, None), (1, 1, 1, 0, None), (64, 1 << 22, 9, 3, None),
    # K2: the giant oracle, the canonical batch's 41 and 42 columns, one
    # column, a multiple of 32, the widest whole rows, column groups
    (1, 1 << 20, None, 0, 14), (16, 70000, None, 0, 41),
    (16, 70000, None, 0, 42), (1000, 2000, None, 0, 1),
    (1, 1 << 20, None, 0, 32), (1, 1 << 20, None, 0, 95),
    (1, 1 << 20, None, 0, 96), (4, 50000, None, 0, 1024),
])
def test_range_plan_matches_source(cuda, batch, n, n_cols, slots, f):
    if f is None:
        assert sm.kernel_range_plan(batch, n, n_cols, slots) == \
            sm.range_plan(batch, n, n_cols, slots)
        return
    assert sm.kernel_sum_plan(batch, n, f) == sm.sum_plan(batch, n, f)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    args, _ = inputs(1, 100, 5, 0, seed=1)
    args = [a.to(cuda) for a in args]
    args[0] = args[0].cpu()
    with pytest.raises(ValueError):
        sm.fused_moments_sorted(*args[:4], None, args[5], 5, 0)


@pytest.mark.cuda
def test_downsample_on_card_matches_cpu(cuda):
    """One kernel launch per batch; integer outputs equal the CPU path's."""
    rng = np.random.default_rng(3)
    centres = rng.uniform(-8, 8, size=(2, 40, 1, 3))
    pts = (centres + rng.normal(scale=0.4, size=(2, 40, 60, 3))).reshape(2, -1, 3)
    pts = torch.from_numpy(pts.astype(np.float32))
    before = sm.fused_moments_sorted.launches
    gpu = ndt_downsample(pts.to(cuda), 64)
    assert sm.fused_moments_sorted.launches == before + 1
    cpu = ndt_downsample(pts, 64)
    for name in ("voxel_size", "num_valid", "counts", "zyx", "converged"):
        assert torch.equal(getattr(gpu[4], name).cpu(), getattr(cpu[4], name)), name
    torch.testing.assert_close(gpu[4].means.cpu(), cpu[4].means, rtol=1e-5,
                               atol=1e-5)


def sparse_tags(seg, n_tags, rng):
    first = np.ones(seg.shape, bool)
    first[1:] = seg[1:] != seg[:-1]
    return [np.where(first, rng.integers(0, 1 << 12, seg.shape), 0)
            .astype(np.float32) for _ in range(n_tags)]


def ranks(n, k, dropped, rng):
    seg = np.zeros(n, np.int32)
    seg[rng.choice(n - 1, size=k - 1, replace=False) + 1] = 1
    seg = np.cumsum(seg).astype(np.int32)
    if dropped:
        seg[-dropped:] = k
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,n_tags,dropped,layout,sparse", [
    (200000, 2504, 4, 5000, "ranks", True), (3000, 3000, 1, 0, "ranks", True),
    (5000, 1, 8, 0, "ranks", True), (100, 40, 2, 60, "ranks", True),
    (1 << 20, 1, 1, 0, "one", True),         # one segment, the whole cloud
    (5000, 5000, 4, 0, "singletons", True),
    (60000, 200, 8, 0, "edges", True),       # runs across tile/range edges
    (300000, 2504, 4, 0, "gaps", True),      # empty rows, long dropped tail
    (100000, 700, 4, 0, "edges", False),     # dense columns: within the bound
])
def test_segment_tags_kernel_matches_plain(cuda, n, k, n_tags, dropped,
                                           layout, sparse):
    rng = np.random.default_rng(n + n_tags)
    seg = (ranks(n, k, dropped, rng) if layout == "ranks"
           else layout_ids(layout, 1, n, k, rng)[0])
    tags = (sparse_tags(seg, n_tags, rng) if sparse
            else [rng.normal(size=n).astype(np.float32) for _ in range(n_tags)])
    seg = torch.from_numpy(seg).to(cuda)
    tags = [torch.from_numpy(t).to(cuda) for t in tags]
    before = sm.segment_tags_sorted.launches
    out = sm.segment_tags_sorted(seg, tags, k)
    again = sm.segment_tags_sorted(seg, tags, k)
    torch.cuda.synchronize()
    assert sm.segment_tags_sorted.launches == before + 2
    assert torch.equal(out, again)
    ref64 = sm.segment_tags_sorted_plain(seg, [t.double() for t in tags], k)
    bound = sm.segment_tags_error_bound(seg, tags, k)
    assert bool(((out.double() - ref64).abs() <= 2 * bound).all())
    if sparse:  # one nonzero a segment: exact
        assert torch.equal(out, sm.segment_tags_sorted_plain(seg, tags, k))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,k,f,layout,offset", [
    ((), 300000, 2100, 14, "ranks", 0), ((), 20000, 500, 42, "ranks", 0),
    ((2,), 5000, 64, 33, "ranks", 0), ((), 1000, 1, 1, "ranks", 0),
    ((3,), 37, 30, 16, "ranks", 0),
    ((), 200000, 2504, 32, "ranks", 0),      # pitch 32: the bank-conflict case
    ((16,), 70000, 1209, 41, "random", 0),   # the canonical batch's width
    ((2,), 20000, 300, 256, "ranks", 0),     # column groups
    ((), 9000, 40, 1000, "edges", 0),        # groups, a narrow last one
    ((), 300000, 80, 14, "long", 0),         # runs longer than a chunk
    ((4,), 60000, 700, 41, "gaps", 0),       # empty rows, long dropped tail
    ((16,), 4096, 4000, 14, "singletons", 0),
    ((2,), 50000, 180, 41, "edges", 0),      # runs across tile/chunk edges
    ((), 100000, 900, 14, "random", 1),      # rows not 16-byte aligned
    ((), 100000, 900, 32, "random", 3),
])
def test_segment_sum_kernel_matches_plain(cuda, lead, n, k, f, layout, offset):
    rng = np.random.default_rng(n + f)
    b = int(np.prod(lead))
    if layout == "ranks":
        seg = np.stack([ranks(n, k, 9 if f > 32 else 0, rng) for _ in range(b)])
    else:
        seg = layout_ids(layout, b, n, k, rng)
    seg = torch.from_numpy(seg.reshape(lead + (n,))).to(cuda)
    values = rng.normal(size=b * n * f + offset).astype(np.float32)
    # a contiguous view `offset` floats into its storage
    feats = torch.from_numpy(values).to(cuda)[offset:].view(lead + (n, f))
    before = sm.segment_sum_sorted.launches
    out = sm.segment_sum_sorted(feats, seg, k)
    again = sm.segment_sum_sorted(feats, seg, k)
    torch.cuda.synchronize()
    assert sm.segment_sum_sorted.launches == before + 2  # one launch a call
    assert torch.equal(out, again)  # a fixed summation order
    ref64 = sm.segment_sum_sorted_plain(feats.double(), seg, k)
    bound = sm.segment_sum_error_bound(feats, seg, k)
    assert bool(((out.double() - ref64).abs() <= 2 * bound).all())


@pytest.mark.cuda
def test_kernels_on_empty_inputs_return_zeros_without_a_launch(cuda):
    """No rows (N = 0) or no segments: zeros like the plain versions, and
    no launch counted."""
    counts = [k.launches for k in (sm.fused_moments_sorted,
                                   sm.segment_tags_sorted,
                                   sm.segment_sum_sorted)]
    for n, k in ((0, 5), (4, 0)):
        col = torch.zeros((2, n), device=cuda)
        seg = torch.zeros((2, n), dtype=torch.int32, device=cuda)
        out = sm.fused_moments_sorted(col, col, col, col, None, seg, k, 0,
                                      tags=[col])
        assert torch.equal(out, torch.zeros((2, k, 14), device=cuda))
        out = sm.segment_tags_sorted(seg[0], [col[0]], k)
        assert torch.equal(out, torch.zeros((k, 1), device=cuda))
        out = sm.segment_sum_sorted(col[..., None], seg, k)
        assert torch.equal(out, torch.zeros((2, k, 1), device=cuda))
    assert [k.launches for k in (sm.fused_moments_sorted,
                                 sm.segment_tags_sorted,
                                 sm.segment_sum_sorted)] == counts


@pytest.mark.cuda
def test_giant_downsample_nccl_matches_gloo_cpu(cuda):
    """The point-sharded downsample on a one-rank NCCL group on the card,
    against a one-rank gloo group on the CPU: the same integer outputs;
    one K1 launch and one K3 launch per search evaluation plus the merge."""
    rng = np.random.default_rng(7)
    centres = rng.uniform(-20, 20, size=(300, 1, 3))
    pts = (centres + rng.normal(scale=0.5, size=(300, 70, 3))).reshape(-1, 3)
    pts = torch.from_numpy(pts.astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        group = mesh.make_group(dev)
        try:
            k1 = sm.fused_moments_sorted.launches
            k3 = sm.segment_tags_sorted.launches
            out[dev] = make_point_sharded_downsample(200, group=group)(
                pts.to(dev))
            if dev == "cuda":
                assert sm.fused_moments_sorted.launches == k1 + 1
                assert sm.segment_tags_sorted.launches >= k3 + 2
        finally:
            mesh.release_group()
    gpu, cpu = out["cuda"], out["cpu"]
    for name in ("voxel_size", "num_valid", "counts", "zyx", "converged"):
        assert torch.equal(getattr(gpu[4], name).cpu(), getattr(cpu[4], name)), name
    assert torch.equal(gpu[3].cpu(), cpu[3])
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_segment_moments_kernel_on_tagged_training_inputs(cuda):
    """K1 with 29 class slots on the real tagged sorted inputs of a small
    training batch (chip_smoke's inputs and check: counts, class histogram
    and tags exact, sums within twice the f32 bound of the float64 plain
    version, two launches bit-identical); and the tagged preprocessing's
    class histograms equal the CPU's."""
    rng = np.random.default_rng(3)
    centres = rng.uniform(-10, 10, size=(4, 40, 1, 3))
    pts = (centres + rng.normal(scale=0.4, size=(4, 40, 501, 3))
           ).reshape(4, -1, 3)[:, :20000].astype(np.float32)
    labels = rng.integers(0, 28, (4, 20000)).astype(np.int32)
    x = chip_smoke.canonical_inputs(torch.from_numpy(pts).cuda(), 500,
                                    torch.from_numpy(labels).cuda())
    assert x["slots"] == 29
    assert chip_smoke.run_kernel(x).shape == (4, x["k"], 13 + 29 + 3)
    chip_smoke.check_kernel(x, "tagged training inputs")
    gpu = ndt_preprocessing_with_state(500, torch.from_numpy(pts).cuda(),
                                       torch.from_numpy(labels).cuda(), 28,
                                       search="fast")[4]
    cpu = ndt_preprocessing_with_state(
        500, torch.from_numpy(pts), torch.from_numpy(labels), 28,
        fixed_voxel_sizes=gpu.voxel_size.cpu())[4]
    assert torch.equal(gpu.class_hist.cpu(), cpu.class_hist)
    assert torch.equal(gpu.counts.cpu(), cpu.counts)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One train step of the same TrainState on the card and on the CPU
    (chip_smoke.small_step_check, which states the tolerances): eight
    clouds without a 2- or 3-point voxel, one K1 launch on the card,
    metrics as scalars on the step's device."""
    chip_smoke.small_step_check()


@pytest.mark.cuda
def test_classification_step_on_card_matches_cpu(cuda):
    """One classification step of the same TrainState on the card and on
    the CPU (chip_smoke.small_cls_step_check, compare_step's tolerances):
    eight clouds, one K1 launch on the card, the accuracy to one cloud."""
    chip_smoke.small_cls_step_check()


@pytest.mark.cuda
def test_multiscale_step_on_card_matches_cpu(cuda):
    """One NDT-Net++ segmentation step of the same TrainState on the card
    and on the CPU (chip_smoke.small_multiscale_step_check): eight clouds
    at fine 16 and coarse 8 NDs, two K1 launches on the card."""
    chip_smoke.small_multiscale_step_check()


def variant_points():
    """Four clouds of 20000 points (make_batch), the last replaced by
    chip_smoke's outlier cloud."""
    pts = chip_smoke.make_batch(4, 20000, seed=2)
    pts[-1] = chip_smoke.outlier_cloud(20000, seed=3)
    return torch.from_numpy(pts)


@pytest.mark.cuda
def test_segment_moments_kernel_on_pair_key_inputs(cuda):
    """K1 on the real sorted inputs of a pair-key build whose last cloud is
    the outlier cloud (voxel coordinates up to ~40000 in the tag
    columns): chip_smoke.check_kernel's checks."""
    x = chip_smoke.canonical_inputs(variant_points().to(cuda), 500,
                                    key_mode="pair")
    assert float(x["tags"][2].max()) > 4096  # the outlier's x coordinate
    chip_smoke.check_kernel(x, "pair-key inputs with the outlier cloud")


@pytest.mark.cuda
@pytest.mark.parametrize("search,key_mode,prune_order", [
    ("grid", "packed", "ascending"), ("grid", "pair", "ascending"),
    ("probe", "pair", "ascending"), ("probe", "packed", "legacy_c"),
])
def test_sampler_variants_on_card_match_cpu(cuda, search, key_mode,
                                            prune_order):
    """One K1 launch a downsample; the outlier cloud converged under pair
    keys only; the card's state and emit against the CPU at the card's
    sizes (chip_smoke.check_variant_vs_cpu)."""
    pts = variant_points().to(cuda)
    before = sm.fused_moments_sorted.launches
    out = ndt_downsample(pts, 500, search=search, key_mode=key_mode,
                         prune_order=prune_order)
    assert sm.fused_moments_sorted.launches == before + 1
    assert bool(out[4].converged[:-1].all())
    assert bool(out[4].converged[-1]) == (key_mode == "pair")
    chip_smoke.check_variant_vs_cpu(pts, out, search, key_mode, prune_order,
                                    m=500, clouds=(0, 1, 2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_fps_on_card_matches_cpu(cuda, masked):
    """FPS indices on the card equal the CPU's on an exact-arithmetic
    cloud (chip_smoke.exact_cloud: every distance exact in f32, ties
    common), with and without a mask, batched."""
    pts = torch.stack([torch.from_numpy(chip_smoke.exact_cloud(20000, s))
                       for s in (1, 2)])
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(4).random((2, 20000))
                                > 0.3)
        mask[:, 0] = True
    gpu = farthest_point_sampling(pts.to(cuda), 1000,
                                  None if mask is None else mask.to(cuda))
    cpu = farthest_point_sampling(pts, 1000, mask)
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
def test_pointnet_step_on_card_matches_cpu(cuda):
    """One PointNet segmentation step of the same TrainState on the card
    and on the CPU (chip_smoke.small_pointnet_step_check, compare_step's
    tolerances): no K1 launch."""
    chip_smoke.small_pointnet_step_check()


# ---- the trainer extras: the graph epoch, bf16 ----

def graph_setup(n_clouds=8, n=8192, m=256, classes=4):
    """A DeviceCachedDataset of n_clouds example_cloud clouds with int
    labels in 1..4 by the signs of x and y, and the probe-search
    segmentation steps at m NDs."""
    pts = np.stack([chip_smoke.example_cloud(1, n, seed=s)[0]
                    for s in range(n_clouds)])
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    ds = DeviceCachedDataset(list(zip(pts, labels)), "cuda")
    return ds, make_ndt_seg_step(m, classes, "probe")


def small_state(**kw):
    return create_train_state(4, 64, lambda _: 1e-3, **kw)


@pytest.mark.cuda
def test_graph_epoch_equals_the_per_step_epoch(cuda):
    """make_epoch_scan's CUDA graph (2 steps of 4 clouds) against the
    per-step loop over the same DeviceCachedDataset and order, from the
    same weights and the same (capturable) Adam: metrics, weights,
    BatchNorm buffers and Adam's state bit for bit; the eval graph against
    the per-step eval too."""
    ds, (step, eval_step) = graph_setup()
    eager, graph = make_capturable(small_state()), small_state()
    eager, me = run_epoch(step, eager, ds.loader(4, True, 0), True)
    graph, mg = run_epoch_scan(make_epoch_scan(step), graph, ds, 4, True, 0)
    assert me == mg and eager.step == graph.step == 2
    for a, b in zip(eager.model.state_dict().values(),
                    graph.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(eager.optimizer.state.values(),
                    graph.optimizer.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in p)
    assert (run_epoch(eval_step, graph, ds.loader(4, False), False)[1]
            == run_epoch_scan(make_epoch_scan(eval_step, False), graph, ds, 4,
                              False)[1])


@pytest.mark.cuda
def test_graph_epoch_resumes_from_a_checkpoint(cuda, tmp_path):
    """A checkpoint of a state after a graph epoch (capturable Adam)
    restores into a fresh state (plain Adam, counters on the host), whose
    graph epoch makes it capturable again (make_capturable, then
    place_adam_steps moves the counters to the card): it equals the next
    graph epoch of the state that wrote the checkpoint bit for bit."""
    from ndtpu_torch.train.state import restore_checkpoint, save_checkpoint

    ds, (step, _) = graph_setup()
    state = small_state()
    state, _ = run_epoch_scan(make_epoch_scan(step), state, ds, 4, True, 0)
    path = save_checkpoint(state, str(tmp_path / "ckpt"))
    resumed = restore_checkpoint(small_state(), path)
    assert resumed.rate is None
    assert all(s["step"].device.type == "cpu"
               for s in resumed.optimizer.state.values())
    state, m1 = run_epoch_scan(make_epoch_scan(step), state, ds, 4, True, 1)
    resumed, m2 = run_epoch_scan(make_epoch_scan(step), resumed, ds, 4, True, 1)
    assert m1 == m2 and state.step == resumed.step == 4
    for a, b in zip(state.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replay_makes_no_host_sync_and_launches_k1_once(cuda):
    """The first graph epoch (warm-up steps, the capture, 2 replays): K1's
    wrapper counts the warm-up steps' launches and, apart, the one call
    captured into the graph (chip_smoke.captured_k1); then replays of the
    captured step under sync debug mode "error" raise nothing and the
    profiler sees one K1 kernel a replay (chip_smoke.graph_replays), with
    no launch counted by the wrapper."""
    ds, (step, _) = graph_setup()
    state, scan = small_state(), make_epoch_scan(step)
    before = sm.fused_moments_sorted.launches
    chip_smoke.captured_k1("test epoch",
                           lambda: run_epoch_scan(scan, state, ds, 4))
    assert sm.fused_moments_sorted.launches - before == WARMUP_STEPS
    chip_smoke.graph_replays("test graph", scan, state, ds, 4)
    assert sm.fused_moments_sorted.launches - before == WARMUP_STEPS


@pytest.mark.cuda
def test_dp_step_on_a_one_rank_nccl_group_matches_the_step(cuda):
    """The segmentation step at the small width without a group and as
    the DP step on a one-rank NCCL group: all-reduces only, their bytes
    within [param_bytes, 1.15 param_bytes + 4096], one K1 launch each,
    the states compared (chip_smoke.dp_step_check)."""
    got = chip_smoke.small_dp_step_check()
    assert got["param_bytes"] <= got["bytes"]


@pytest.mark.cuda
def test_dp_graph_epoch_equals_the_dp_per_step_epoch(cuda):
    """On a one-rank NCCL group, the graph epoch over a sharded
    DeviceCachedDataset (each step's batch assembled by all-reduces
    inside the graph) against the per-step DP epoch over the host loader,
    bit for bit; replays with no host sync and one K1 kernel each
    (chip_smoke.dp_graph_epoch)."""
    ds, (step, _) = graph_setup()
    host = list(zip(*(a.cpu().numpy() for a in ds.arrays)))
    mesh.make_data_group("cuda")
    try:
        replays, times = chip_smoke.dp_graph_epoch(
            "test DP", step, small_state, host, 4)
    finally:
        mesh.release_group()
    assert replays > 2 and times["dp_gather_bytes_per_step"] == sum(
        a[:4].numel() * a.element_size() for a in ds.arrays)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_process(cuda):
    """Two worker processes on the one card in a gloo group, float64, 2
    steps at lr 0 and 2 at lr 1e-3, against one process on the whole
    batch (chip_smoke.two_rank_gloo_check); rank 1 prints nothing."""
    assert chip_smoke.two_rank_gloo_check() == 2 * len(chip_smoke.TR_LRS) * (
        chip_smoke.TR_STEPS)


# bf16 forwards, card against CPU (test_bf16_forwards_on_card_match_cpu):
# eval-mode logits within this share of their largest entry (measured on an
# H100: 5.3e-3 to 2.75e-2); train-mode logits' gap to the float64 model
# within this multiple of the CPU's (measured: 0.78 to 1.07 times)
BF16_CARD_EVAL_TOL = 3e-2
BF16_CARD_TRAIN_RATIO = 1.5


def bf16_forward_case(name):
    """(a model of family ``name`` in bfloat16, compute and parameters, on
    the CPU with random weights; its inputs on the CPU: 8 clouds of 512
    points)."""
    rng = np.random.default_rng(1)
    kw = dict(num_classes=4, feature_dim=64, device="cpu", **chip_smoke.BF16)
    pts = torch.from_numpy(rng.normal(size=(8, 512, 3)).astype(np.float32))
    covs = torch.from_numpy((0.1 * rng.normal(size=(8, 512, 9))).astype(np.float32))
    if name.startswith("ndtnetpp"):
        model = {"ndtnetpp_seg": NDTNetPPSegmentation,
                 "ndtnetpp_cls": NDTNetPPClassification}[name]
        cpu_model = model(fine_res=64, coarse_res=32, **kw)
        p1, c1, _, _, s1 = ndt_preprocessing_with_state(64, pts, None, 4)
        p2, c2, _, _, _ = ndt_preprocessing_with_state(32, pts, None, 4)
        args = (p1, c1, s1, p2, c2)
    else:
        model = {"ndtnet_seg": NDTNetSegmentation,
                 "ndtnet_cls": NDTNetClassification,
                 "pointnet_seg": PointNetSegmentation,
                 "pointnet_cls": PointNetClassification}[name]
        cpu_model = model(**kw)
        args = (pts,) if name.startswith("pointnet") else (pts, covs)
    return chip_smoke.init_random_(cpu_model, 0), args


def float64_twin(model):
    """The same model and weights computing in float64 on the CPU."""
    import copy

    twin = copy.deepcopy(model)
    for mod in twin.modules():
        for attr in ("dtype", "compute_dtype"):
            if getattr(mod, attr, None) is not None:
                setattr(mod, attr, None)
    return twin.double()


def on(a, dev, dtype=None):
    """A model input (a tensor or a dataclass of tensors) on ``dev``, its
    floating tensors in ``dtype`` when given."""
    def move(t):
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)
    if isinstance(a, torch.Tensor):
        return move(a)
    return type(a)(**{f: move(getattr(a, f)) for f in a.__dataclass_fields__})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", ["ndtnet_seg", "ndtnet_cls", "ndtnetpp_seg",
                                  "ndtnetpp_cls", "pointnet_seg",
                                  "pointnet_cls"])
def test_bf16_forwards_on_card_match_cpu(cuda, name, mode):
    """Each model in bfloat16 (compute and parameters) on the card and on
    the CPU from the same weights and inputs, bfloat16 logits out. Eval
    mode: within BF16_CARD_EVAL_TOL of their largest entry (cuBLAS sums
    bfloat16 products in float32 in another order than the CPU). Train
    mode: at these sizes the bfloat16 logits are ill-conditioned (the
    BatchNorms over the B rows of the TNets' FC layers divide by a spread
    that a rounding moves: a relative perturbation of 2**-9 of the inputs
    moves them by 15-55 % of their largest entry on the CPU), so card and
    CPU are each held to the same model in float64 on the CPU: the card's
    gap to it at most BF16_CARD_TRAIN_RATIO times the CPU's."""
    import copy

    cpu_model, args = bf16_forward_case(name)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    train = mode == "train"
    with torch.no_grad():
        ref = (float64_twin(cpu_model).train()(
            *(on(a, "cpu", torch.float64) for a in args), return_logits=True)
            if train else None)
        outs = [m.train(train)(*(on(a, dev) for a in args), return_logits=True)
                for m, dev in ((cpu_model, "cpu"), (card_model, cuda))]
    assert all(o.dtype == torch.bfloat16 for o in outs)
    outs = [o.cpu().float() for o in outs]
    assert outs[1].isfinite().all()
    scale = float(outs[0].abs().max())
    card_cpu = float((outs[0] - outs[1]).abs().max()) / scale
    if not train:
        print(f"{name} eval: card vs CPU {card_cpu:.3e}")
        assert card_cpu <= BF16_CARD_EVAL_TOL, card_cpu
        return
    cpu_gap, card_gap = (float((o.double() - ref).abs().max() / ref.abs().max())
                         for o in outs)
    print(f"{name} train: to float64 card {card_gap:.3e}, CPU {cpu_gap:.3e}; "
          f"card vs CPU {card_cpu:.3e}")
    assert card_gap <= BF16_CARD_TRAIN_RATIO * cpu_gap, (card_gap, cpu_gap)


@pytest.mark.cuda
def test_dense_rounds_the_product_before_the_bias_on_card(cuda):
    """Dense in bfloat16 on the card adds the bias to the rounded bfloat16
    product, as flax's nn.Dense does, and does not fuse it into the GEMM
    (F.linear's cuBLAS epilogue, which rounds once: on these inputs its
    output differs, so the check tells the two apart)."""
    from ndtpu_torch.models.dense import Dense

    torch.manual_seed(0)
    dense = Dense(256, 128, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16).to(cuda)
    x = torch.randn(4096, 256, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        want = torch.matmul(x, dense.weight.t()) + dense.bias
        assert torch.equal(dense(x), want)
        fused = torch.nn.functional.linear(x, dense.weight, dense.bias)
        assert not torch.equal(fused, want)


@pytest.mark.cuda
def test_bf16_step_on_card_matches_cpu(cuda):
    """One bfloat16 segmentation step on the card and on the CPU
    (chip_smoke.bf16_step_check, which states the tolerances)."""
    chip_smoke.bf16_step_check()


@pytest.mark.cuda
def test_stream_on_card_equals_cpu(cuda):
    """tools.stream at 4 frames x 8192 points on the card and with
    --device cpu: the same modes, kept counts and voxel sizes
    (chip_smoke.stream_card_vs_cpu: fixed mode, the exact reference
    search)."""
    frames = chip_smoke.stream_card_vs_cpu(n_frames=4, n_points=8192, m=256)
    assert [mode for mode, _, _ in frames] == ["search", "fixed"] * 2


@pytest.mark.cuda
def test_export_round_trip_on_card(cuda, tmp_path):
    """tools.export of a small segmentation checkpoint, reloaded through
    torch_weights on the card: bit-identical logits on one request
    (chip_smoke.export_round_trip)."""
    from ndtpu_torch.train.loop import make_lr_schedule
    from ndtpu_torch.train.state import save_checkpoint

    state = create_train_state(4, 32, make_lr_schedule(1e-3, 1), seed=1)
    ckpt = save_checkpoint(state, str(tmp_path / "ckpt"))
    points = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 2048, 3)).astype(np.float32)).to(cuda)
    tree = chip_smoke.export_round_trip(ckpt, 4, 32, points, 48,
                                        str(tmp_path / "out" / "seg.pt"))
    assert tree["conv4.weight"].shape == (5, 128, 1)
    assert (tmp_path / "out" / "seg_backbone.pt").exists()


@pytest.mark.cuda
def test_dryrun_multichip_on_a_one_rank_nccl_group(cuda):
    """The multi-device entry on the card: the float64 DP loss at the
    single-process loss, the float32 one within its rounding band, the
    counts, and its K1 and K3 launches."""
    out = dryrun_multichip(1)
    tol = 1e-5 + 1e-5 * abs(out["single_loss"])
    assert abs(out["loss"] - out["single_loss"]) <= tol
    assert abs(out["loss_f32"] - out["single_loss_f32"]) <= max(
        tol, out["band_f32"])
    assert out["counts_sum"] == 128 and np.isfinite(out["multiscale_loss"])
    assert out["launches"] == [{"fused_moments_sorted": 11,
                                "segment_tags_sorted": 1}]


@pytest.mark.cuda
@pytest.mark.parametrize("script", [seed_hit_rate, probe_seed_validate])
def test_seed_scripts_count_on_the_card_as_on_the_cpu(cuda, script):
    chip_smoke.card_vs_cpu_counts(script.main, [
        "--clouds", "4", "--n_samples", "4096", "--n_desired_nds", "256"])


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [0, 1, 29])
@pytest.mark.parametrize("b,n,k", [(16, 70000, 1209), (3, 20000, 500),
                                   (1, 37, 30)])
def test_moment_probes_and_moments_mode_match_plain(cuda, slots, b, n, k):
    """K1's cost probes P1 and P2 against their plain versions, and K1 on
    the moments mode's inputs against fused_moments_sorted_plain
    (chip_smoke.check_probes), on kernel_micro's draws and with classes
    drawn over every slot."""
    _, _, seg = kernel_micro.segment_inputs(b, n, 42, k)
    for classes in (False, True):
        chip_smoke.check_probes(chip_smoke.probe_inputs(seg, slots, k, classes),
                                f"[{b}, {n}] -> {k}, classes {classes}")


@pytest.mark.cuda
def test_kernel_micro_modes_launch_their_kernels(cuda):
    """Each kernel_micro mode launches its kernel (K2, K1, P2, P1) once a
    run and one warm-up, and no other mode launches one."""
    for mode in kernel_micro.MODES:
        before = {m: kern.launches
                  for m, kern in chip_smoke.MICRO_KERNELS.items()}
        kernel_micro.main(["--mode", mode, "--batch", "2", "--n", "4096",
                           "--k", "64", "--k_max", "64", "--inner", "2",
                           "--iters", "1"])
        got = {m: kern.launches - before[m]
               for m, kern in chip_smoke.MICRO_KERNELS.items()}
        assert got == {m: 3 if m == mode else 0
                       for m in chip_smoke.MICRO_KERNELS}, mode


# ---- the bf16x3 branch of K1 and K2 (NDTPU_PALLAS_PRECISION=bf16x3) ----

def k1_inputs(b, n, k, slots, layout, n_tags, seed):
    """``inputs`` on the card as chip_smoke's K1 dict."""
    args, tags = inputs(b, n, k, slots, seed=seed, layout=layout,
                        n_tags=n_tags)
    xt, yt, zt, v, cls, seg = (a.cuda() for a in args)
    return dict(xt=xt, yt=yt, zt=zt, v=v, cls=cls if slots else None, seg=seg,
                tags=[t.cuda() for t in tags], slots=slots, k=k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,slots,layout,n_tags", [
    (3, 20000, 500, 0, "random", 3), (3, 20000, 500, 29, "random", 3),
    (1, 37, 30, 2, "random", 3), (2, 5000, 1, 0, "random", 0),
    (16, 4096, 4000, 0, "singletons", 0),    # 16 segments a 16-point k-step
    (16, 4096, 4000, 29, "singletons", 8),
    (1, 1 << 20, 1, 1, "one", 2),            # one segment, the whole cloud
    (16, 70000, 300, 29, "edges", 8),        # runs across quarters and tiles
    (1, 50000, 180, 1, "edges", 2),
    (1, 200000, 3000, 1, "gaps", 3),         # empty rows, long dropped tail
    (16, 20000, 700, 29, "gaps", 8),
    (2, 300000, 80, 0, "long", 1),           # runs longer than a chunk
    (2, 5000, 60, 40, "random", 8),          # 58 columns: two column groups
])
def test_segment_moments_bf16x3_kernel_matches_plain(cuda, b, n, k, slots,
                                                     layout, n_tags):
    """chip_smoke.check_k1_bf16x3: bit-identical launches, the count,
    class and tag columns equal to the bf16x3 plain version, the sums
    within its bound; one launch a call, none of the f32 kernel's. A
    cloud alone gets another launch plan, so its sums may take another
    order: its count, class and tag columns equal its row of the batch,
    the rest within twice the bound."""
    x = k1_inputs(b, n, k, slots, layout, n_tags, seed=n + slots)
    k1, f32 = sm.fused_moments_sorted_bf16x3, sm.fused_moments_sorted
    before = (k1.launches, f32.launches)
    chip_smoke.check_k1_bf16x3(x, f"{layout} [{b}, {n}] -> {k}")
    # the check's two launches of the branch and one of the f32 kernel
    assert (k1.launches, f32.launches) == (before[0] + 2, before[1] + 1)
    out = chip_smoke.run_probe(k1, x)
    one = chip_smoke.run_probe(k1, {**{c: x[c][0] for c in ("xt", "yt", "zt", "v",
                                                         "seg")},
                                 "cls": None if x["cls"] is None else x["cls"][0],
                                 "tags": [t[0] for t in x["tags"]],
                                 "slots": slots, "k": k})
    exact = [0] + list(range(13, out.shape[-1]))
    assert torch.equal(one[..., exact], out[0][..., exact])
    bound = chip_smoke.run_probe(sm.fused_moments_bf16x3_error_bound, x)[0]
    assert bool(((one - out[0]).abs().double() <= 2 * bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,k,f,layout", [
    ((), 300000, 2100, 14, "ranks"), ((), 20000, 500, 42, "ranks"),
    ((16,), 70000, 1209, 41, "random"),     # the canonical batch's width
    ((2,), 5000, 64, 33, "ranks"), ((), 1000, 1, 1, "ranks"),
    ((3,), 37, 30, 16, "ranks"), ((), 100000, 900, 48, "ranks"),
    ((), 100000, 900, 49, "ranks"),         # column groups from 49
    ((2,), 20000, 300, 256, "ranks"), ((), 9000, 40, 1000, "edges"),
    ((), 300000, 80, 14, "long"), ((4,), 60000, 700, 41, "gaps"),
    ((16,), 4096, 4000, 14, "singletons"), ((2,), 50000, 180, 42, "edges"),
])
def test_segment_sum_bf16x3_kernel_matches_plain(cuda, lead, n, k, f, layout):
    """chip_smoke.check_k2_bf16x3 at K2's widths: whole rows up to 48
    columns, groups of 32 above."""
    rng = np.random.default_rng(n + f)
    b = int(np.prod(lead))
    if layout == "ranks":
        seg = np.stack([ranks(n, k, 9 if f > 32 else 0, rng) for _ in range(b)])
    else:
        seg = layout_ids(layout, b, n, k, rng)
    seg = torch.from_numpy(seg.reshape(lead + (n,))).to(cuda)
    feats = torch.from_numpy(rng.normal(size=lead + (n, f)).astype(np.float32)
                             ).to(cuda)
    before = sm.segment_sum_sorted_bf16x3.launches
    chip_smoke.check_k2_bf16x3(feats, seg, k, f"{layout} {lead} {n} x {f}")
    assert sm.segment_sum_sorted_bf16x3.launches == before + 2


@pytest.mark.cuda
def test_bf16x3_kernels_capture_into_a_cuda_graph(cuda):
    """Calls captured into a CUDA graph are counted in ``captured``, not in
    ``launches``, through the precision switch too; replays give the
    eager outputs."""
    x = k1_inputs(3, 20000, 500, 29, "random", 3, seed=5)
    seg = x["seg"]
    feats = torch.randn(seg.shape + (41,), device=cuda)
    k1, k2 = sm.fused_moments_sorted_bf16x3, sm.segment_sum_sorted_bf16x3
    eager = (chip_smoke.run_probe(k1, x), k2(feats, seg, 500))
    counts = [(k.launches, k.captured) for k in (k1, k2)]
    graph = torch.cuda.CUDAGraph()
    with chip_smoke.bf16x3(), torch.cuda.graph(graph):
        out = (chip_smoke.run_probe(sm.fused_moments_sorted, x),
               sm.segment_sum_sorted(feats, seg, 500))
    assert [(k.launches, k.captured) for k in (k1, k2)] == [
        (c[0], c[1] + 1) for c in counts]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.cuda
def test_bf16x3_wrappers_raise_instead_of_falling_back(cuda):
    """What the kernels refuse (more than 65535 column groups) raises,
    with no launch of either kernel counted; mixed devices raise; empty
    inputs give zeros without a launch."""
    kernels = (sm.fused_moments_sorted_bf16x3, sm.segment_sum_sorted_bf16x3,
               sm.fused_moments_sorted, sm.segment_sum_sorted)
    counts = [k.launches for k in kernels]
    seg = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    col = torch.ones((1, 1), device=cuda)
    with pytest.raises(RuntimeError):
        sm.segment_sum_sorted_bf16x3(
            torch.ones((1, 1, 32 * 65535 + 1), device=cuda), seg, 1)
    slots = 48 * 65536
    with pytest.raises(RuntimeError):
        sm.fused_moments_sorted_bf16x3(col, col, col, col, seg, seg, 1, slots)
    with chip_smoke.bf16x3(), pytest.raises(RuntimeError):
        sm.segment_sum_sorted(torch.ones((1, 1, 32 * 65535 + 1), device=cuda),
                              seg, 1)
    with pytest.raises(ValueError):
        sm.fused_moments_sorted_bf16x3(col.cpu(), col, col, col, None, seg, 1, 0)
    for n, k in ((0, 5), (4, 0)):
        c = torch.zeros((2, n), device=cuda)
        s = torch.zeros((2, n), dtype=torch.int32, device=cuda)
        assert torch.equal(sm.fused_moments_sorted_bf16x3(c, c, c, c, None, s, k,
                                                          0, tags=[c]),
                           torch.zeros((2, k, 14), device=cuda))
        assert torch.equal(sm.segment_sum_sorted_bf16x3(c[..., None], s, k),
                           torch.zeros((2, k, 1), device=cuda))
    assert [k.launches for k in kernels] == counts


@pytest.mark.cuda
@pytest.mark.parametrize("label,values", chip_smoke.MODES)
def test_modes_give_the_default_request_on_card(cuda, label, values):
    """A small request under each A/B mode equals the default's bit for
    bit on the card."""
    pts = torch.from_numpy(chip_smoke.example_cloud(2, 4096, seed=3)).to(cuda)
    outs = []
    for vals in ({k: None for k in values}, values):
        with chip_smoke.environ(vals):
            outs.append(ndt_downsample(pts, 256, search="probe"))
    a, b = outs
    for x, y in list(zip(a[:4], b[:4])) + [(a[4].min_kl, b[4].min_kl),
                                          (a[4].max_kl, b[4].max_kl)]:
        assert torch.equal(x, y), label
