"""The port's voxel math against the JAX package, with the cases of
tests/test_voxel.py (integer outputs exact, floats to 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import voxel as jv
from ndtpu_torch.core import voxel as tv

SIZE_CASES = [
    (12, (-2.0, -1.5, -0.5), (2.0, 1.5, 0.5)),
    (32, (-2.0, -2.0, -1.0), (2.0, 2.0, 1.0)),
    (256, (-2.0, -2.0, -1.0), (2.0, 2.0, 1.0)),
    (8, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    (1000, (-19.7, -20.3, -18.9), (20.1, 19.6, 21.4)),
]


@pytest.mark.parametrize("n,mins,maxs", SIZE_CASES)
def test_estimate_voxel_size_and_grid(n, mins, maxs):
    lo = np.asarray(mins, np.float32)
    hi = np.asarray(maxs, np.float32)
    s_j, lens_j, off_j = jv.estimate_voxel_size(n, jnp.asarray(lo), jnp.asarray(hi))
    s_t, lens_t, off_t = tv.estimate_voxel_size(n, torch.from_numpy(lo),
                                                torch.from_numpy(hi))
    # log/exp may differ by an ulp between XLA and torch
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    for size in (0.37, 1.0, float(s_j)):
        g_j, o_j = jv.estimate_voxel_grid(jnp.asarray(lo), jnp.asarray(hi),
                                          jnp.float32(size))
        g_t, o_t = tv.estimate_voxel_grid(torch.from_numpy(lo),
                                          torch.from_numpy(hi),
                                          torch.tensor(size))
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        assert g_t.dtype == torch.int32


def test_axis_and_space_conversions_match():
    """metric<->voxel on random points, in both the [N, 3] and the SoA
    per-axis forms, including points outside the grid (clamped)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-6, 6, size=(500, 3)).astype(np.float32)
    lens = np.array([7, 5, 9], np.int32)
    offs = np.array([-5.0, -4.0, -5.5], np.float32)
    size = np.float32(1.3)
    c_j, ok_j = jv.metric_to_voxel_space(jnp.asarray(pts), size,
                                         jnp.asarray(lens), jnp.asarray(offs))
    c_t, ok_t = tv.metric_to_voxel_space(torch.from_numpy(pts),
                                         torch.tensor(size),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(offs))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not ok_t.all() and ok_t.any()
    for a in range(3):
        ax_j = jv.metric_to_voxel_axis(jnp.asarray(pts[:, a]), size,
                                       lens[a], offs[a])
        ax_t = tv.metric_to_voxel_axis(torch.from_numpy(pts[:, a]),
                                       torch.tensor(size),
                                       torch.tensor(lens[a]),
                                       torch.tensor(offs[a]))
        np.testing.assert_array_equal(ax_t.numpy(), np.asarray(ax_j))
        back_j = jv.voxel_to_metric_axis(ax_j, size, offs[a])
        back_t = tv.voxel_to_metric_axis(ax_t, torch.tensor(size),
                                         torch.tensor(offs[a]))
        np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), rtol=1e-6)
    m_j = jv.voxel_to_metric_space(c_j, size, jnp.asarray(offs))
    m_t = tv.voxel_to_metric_space(c_t, torch.tensor(size), torch.from_numpy(offs))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6)


# tests/test_voxel.py: centred grids of voxel size 1
@pytest.mark.parametrize("point,lens,expected", [
    ((0.0, 0.0, 0.0), (5, 3, 1), (2, 1, 0)),
    ((0.0, 1.0, 0.0), (5, 3, 1), (2, 2, 0)),
    ((0.0, 1.49999, 0.0), (5, 3, 1), (2, 2, 0)),
])
def test_metric_to_voxel_reference_cases(point, lens, expected):
    offs = torch.tensor(-np.asarray(lens) / 2.0, dtype=torch.float32)
    coords, ok = tv.metric_to_voxel_space(torch.tensor([point]), 1.0,
                                          torch.tensor(lens), offs)
    assert bool(ok[0])
    assert tuple(coords[0].tolist()) == expected


def test_linearization_and_neighbors_match():
    lens = np.array([5, 3, 2], np.int32)
    coords = np.stack(np.meshgrid(np.arange(5), np.arange(3), np.arange(2),
                                  indexing="ij"), -1).reshape(-1, 3)
    idx_j = jv.voxel_pos_to_index(jnp.asarray(coords), jnp.asarray(lens))
    idx_t = tv.voxel_pos_to_index(torch.from_numpy(coords), torch.from_numpy(lens))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(
        tv.index_to_voxel_pos(idx_t, torch.from_numpy(lens)).numpy(), coords)
    for i in (0, 7, 29):
        n_j, v_j = jv.neighbor_indices(jnp.asarray(i), jnp.asarray(lens))
        n_t, v_t = tv.neighbor_indices(torch.tensor(i), torch.from_numpy(lens))
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_pointcloud_limits_match():
    pts = np.array([[1.0, 2.0, 3.0], [-1.0, 5.0, -2.0], [0.5, -4.0, 0.0],
                    [100.0, 100.0, 100.0]], np.float32)
    mask = np.array([True, True, True, False])
    for m in (None, mask):
        lo_j, hi_j = jv.pointcloud_limits(jnp.asarray(pts),
                                          None if m is None else jnp.asarray(m))
        lo_t, hi_t = tv.pointcloud_limits(torch.from_numpy(pts),
                                          None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
