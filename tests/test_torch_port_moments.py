"""The port's segment-moments kernel (K1) and moments module against the JAX
package.

On the CPU the port's wrapper runs the kernel's plain version; the JAX
side runs the Pallas kernel in interpret mode (``fused_moments_sorted``)
and the XLA branch of ``segment_moments_soa``. Counts, class histograms
and tag columns are integers or single values and must match exactly;
sums may differ in the last bits because the one-hot contraction sums in
another order (atol 1e-4, as tests/test_pallas.py). The CUDA kernel
itself is held against the plain version by tests/test_torch_port_cuda.py
(skipped without a card) and by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import moments as jm
from ndtpu.ops.pallas import segment_moments as jsm
from ndtpu_torch.core import moments as tm
from ndtpu_torch.ops import segment_moments as tsm


def dense_ranks(n, k, rng):
    """Non-decreasing ids with unit steps (the kernel's precondition)."""
    steps = np.zeros(n, np.int32)
    pos = rng.choice(n - 1, size=min(k - 1, n - 1), replace=False) + 1
    steps[pos] = 1
    return np.cumsum(steps).astype(np.int32)


def k1_inputs(n, k, slots, n_tags, rng, lead=()):
    """Kernel inputs as numpy: dense ranks with dropped sentinel rows,
    pre-masked coordinates, class tags, and tag columns nonzero only on
    each segment's first row."""
    shape = lead + (n,)
    seg = np.stack([dense_ranks(n, k, rng) for _ in range(int(np.prod(lead)))]
                   ).reshape(shape) if lead else dense_ranks(n, k, rng)
    seg[..., -7:] = k  # dropped sentinel rows
    v = (rng.random(shape) > 0.1).astype(np.float32)
    xt, yt, zt = ((rng.normal(size=shape) * v).astype(np.float32)
                  for _ in range(3))
    cls = rng.integers(0, max(slots, 1), size=shape).astype(np.int32)
    first = np.ones(shape, bool)
    first[..., 1:] = seg[..., 1:] != seg[..., :-1]
    tags = tuple(np.where(first, rng.integers(0, 1000, size=shape), 0)
                 .astype(np.float32) for _ in range(n_tags))
    return xt, yt, zt, v, cls, seg, tags


def port_k1(xt, yt, zt, v, cls, seg, tags, num_segments, slots):
    t = torch.from_numpy
    return tsm.fused_moments_sorted(
        t(xt), t(yt), t(zt), t(v), t(cls) if slots else None, t(seg),
        num_segments, slots, tags=[t(a) for a in tags],
    ).numpy()


def assert_k1_close(got, ref, slots):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])          # counts
    np.testing.assert_array_equal(got[..., 13:], ref[..., 13:])      # hist, tags
    np.testing.assert_allclose(got[..., 1:13], ref[..., 1:13], atol=1e-4)


@pytest.mark.parametrize("n,k,slots,n_tags,block", [
    (1000, 37, 0, 3, 128),   # the serving specialisation: no class column
    (1000, 37, 5, 0, 128),
    (513, 5, 1, 3, 256),     # N not a multiple of the block: padding
    (64, 40, 3, 3, 512),     # tiny input, block clamped
    (4096, 64, 29, 3, 1024),  # the trainers' 28+1 slots, sub-blocked
])
def test_k1_plain_matches_pallas_interpret(n, k, slots, n_tags, block):
    rng = np.random.default_rng(3)
    xt, yt, zt, v, cls, seg, tags = k1_inputs(n, k, slots, n_tags, rng)
    ref = jsm.fused_moments_sorted(
        *map(jnp.asarray, (xt, yt, zt, v, cls, seg)), k, slots,
        block_n=block, tags=tuple(map(jnp.asarray, tags)) or None,
    )
    got = port_k1(xt, yt, zt, v, cls, seg, tags, k, slots)
    assert_k1_close(got, ref, slots)


@pytest.mark.parametrize("slots", [0, 4])
def test_k1_batched_matches_pallas_custom_vmap(slots):
    """[B, N] in one call against the Pallas kernel's custom_vmap rule
    (each cloud its own row region)."""
    rng = np.random.default_rng(4)
    b, n, k = 3, 700, 23
    xt, yt, zt, v, cls, seg, tags = k1_inputs(n, k, slots, 3, rng, lead=(b,))

    def one(xt, yt, zt, v, cls, seg, *tags):
        return jsm.fused_moments_sorted(xt, yt, zt, v, cls, seg, k, slots,
                                        block_n=256, tags=tags)

    ref = jax.vmap(one)(*map(jnp.asarray, (xt, yt, zt, v, cls, seg) + tags))
    got = port_k1(xt, yt, zt, v, cls, seg, tags, k, slots)
    assert got.shape == (b, k, 13 + slots + 3)
    assert_k1_close(got, ref, slots)


def test_segment_moments_soa_matches_xla_branch():
    """The port's segment_moments_soa (plain path on the CPU) against the
    JAX XLA branch, whose column order it copies: bit-identical."""
    rng = np.random.default_rng(5)
    b, n, k, slots = 2, 600, 30, 3
    xt, yt, zt, v, cls, seg, tags = k1_inputs(n, k, slots, 3, rng, lead=(b,))

    def one(xt, yt, zt, v, cls, seg, *tags):
        return jm.segment_moments_soa(xt, yt, zt, v, seg, k, classes=cls,
                                      num_class_slots=slots, tags=tags)

    ref = jax.vmap(one)(*map(jnp.asarray, (xt, yt, zt, v, cls, seg) + tags))
    t = torch.from_numpy
    got = tm.segment_moments_soa(t(xt), t(yt), t(zt), t(v), t(seg), k,
                                 classes=t(cls), num_class_slots=slots,
                                 tags=[t(a) for a in tags])
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)


def _moments_pair(points, centers, seg, k, **kw):
    ref = jm.segment_moments(jnp.asarray(points), jnp.asarray(centers),
                             jnp.asarray(seg), k,
                             **{a: jnp.asarray(b) if not isinstance(b, int)
                                else b for a, b in kw.items()})
    got = tm.segment_moments(torch.from_numpy(points),
                             torch.from_numpy(centers), torch.from_numpy(seg),
                             k, **{a: torch.from_numpy(b)
                                   if not isinstance(b, int) else b
                                   for a, b in kw.items()})
    return got, ref


@pytest.mark.parametrize("case", ["oracle", "far", "dropped", "classes"])
def test_segment_moments_and_finalize_match_jax(case):
    """The cases of tests/test_moments.py: random sorted segments, a cloud
    far from the origin (center shift), invalid rows and overflow segments
    dropped, and the class histogram."""
    rng = np.random.default_rng(0)
    kw = {}
    if case == "oracle":
        n, k = 500, 17
        seg = np.sort(rng.integers(0, k, n)).astype(np.int32)
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        centers = np.zeros_like(pts)
    elif case == "far":
        n, k = 256, 4
        seg = np.sort(rng.integers(0, k, n)).astype(np.int32)
        base = np.array([1000.0, -2000.0, 500.0], np.float32)
        pts = (base + rng.normal(scale=0.1, size=(n, 3))).astype(np.float32)
        centers = np.broadcast_to(base, (n, 3)).copy()
    elif case == "dropped":
        k = 2
        pts = np.ones((8, 3), np.float32)
        centers = np.zeros_like(pts)
        seg = np.array([0, 0, 1, 1, 2, 2, 2, 2], np.int32)
        kw["valid"] = np.array([True] * 6 + [False] * 2)
    else:
        k = 2
        pts = np.zeros((6, 3), np.float32)
        centers = np.zeros_like(pts)
        seg = np.array([0, 0, 0, 1, 1, 1], np.int32)
        kw["classes"] = np.array([2, 2, 1, 0, 3, 3], np.int32)
        kw["num_class_slots"] = 4
    got, ref = _moments_pair(pts, centers, seg, k, **kw)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    np.testing.assert_allclose(got["sum_shift"].numpy(),
                               np.asarray(ref["sum_shift"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["sum_outer"].numpy(),
                               np.asarray(ref["sum_outer"]), rtol=1e-6, atol=1e-6)
    if "classes" in kw:
        np.testing.assert_array_equal(got["class_hist"].numpy(),
                                      np.asarray(ref["class_hist"]))
    seg_centers = centers[:1].repeat(k, 0)
    mean_t, cov_t = tm.finalize_moments(got["counts"], got["sum_shift"],
                                        got["sum_outer"],
                                        torch.from_numpy(seg_centers))
    mean_j, cov_j = jm.finalize_moments(ref["counts"], ref["sum_shift"],
                                        ref["sum_outer"],
                                        jnp.asarray(seg_centers))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-6)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-5,
                               atol=1e-7)


def test_plain_reduction_is_deterministic():
    rng = np.random.default_rng(2)
    xt, yt, zt, v, cls, seg, tags = k1_inputs(1000, 31, 3, 3, rng)
    a = port_k1(xt, yt, zt, v, cls, seg, tags, 31, 3)
    b = port_k1(xt, yt, zt, v, cls, seg, tags, 31, 3)
    np.testing.assert_array_equal(a, b)


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    rng = np.random.default_rng(6)
    xt, yt, zt, v, cls, seg, tags = k1_inputs(100, 9, 2, 1, rng)
    t = torch.from_numpy
    args = [t(xt), t(yt), t(zt), t(v), t(cls), t(seg)]
    before = tsm.fused_moments_sorted.launches
    tsm.fused_moments_sorted(*args, 9, 2, tags=[t(tags[0])])
    assert tsm.fused_moments_sorted.launches == before  # CPU: plain version
    bad = list(args)
    bad[5] = bad[5].long()
    with pytest.raises(TypeError):
        tsm.fused_moments_sorted(*bad, 9, 2)
    bad = list(args)
    bad[0] = torch.from_numpy(np.stack([xt, xt], 1))[:, 0]  # strided view
    with pytest.raises(ValueError):
        tsm.fused_moments_sorted(*bad, 9, 2)
    with pytest.raises(ValueError):
        tsm.fused_moments_sorted(*args[:4], None, args[5], 9, 2)
    with pytest.raises(ValueError):
        tsm.fused_moments_sorted(*args, 9, 2, tags=[t(tags[0])] * 9)
