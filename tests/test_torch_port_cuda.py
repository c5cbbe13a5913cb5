"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc (the kernel is built at first use); every
test here skips without a card. This file imports neither jax nor
``ndtpu``, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -q
"""
import numpy as np
import pytest
import torch

from ndtpu_torch.core.ndt import ndt_downsample
from ndtpu_torch.ops import segment_moments as sm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(b, n, k, slots, seed):
    """[b, n] dense sorted ranks over k segments (the tail dropped with id
    k), masked coordinates, class tags, 3 tag columns nonzero on each
    segment's first row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, n), np.int32)
    for i in range(b):
        seg[i, rng.choice(n - 1, size=k - 1, replace=False) + 1] = 1
    seg = np.cumsum(seg, axis=1).astype(np.int32)
    seg[:, -9:] = k
    v = (rng.random((b, n)) > 0.1).astype(np.float32)
    cols = [(rng.normal(size=(b, n)) * v).astype(np.float32) for _ in range(3)]
    cls = rng.integers(0, max(slots, 1), (b, n)).astype(np.int32)
    first = np.ones((b, n), bool)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    tags = [np.where(first, rng.integers(0, 999, (b, n)), 0).astype(np.float32)
            for _ in range(3)]
    return [torch.from_numpy(a) for a in cols + [v, cls, seg]], \
        [torch.from_numpy(a) for a in tags]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,slots", [
    (3, 20000, 500, 0), (3, 20000, 500, 29), (1, 37, 30, 2), (2, 5000, 1, 0),
])
def test_segment_moments_kernel_matches_plain(cuda, b, n, k, slots):
    args, tags = inputs(b, n, k, slots, seed=n + slots)
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
