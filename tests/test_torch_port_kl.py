"""The port's closed-form KL against the JAX package, with the cases of
tests/test_kl.py.

KL values agree to f32 rounding (rtol 1e-5); which pairs are defined
(the inf pattern) must agree exactly on well-conditioned inputs.
"""
import jax.numpy as jnp
import numpy as np
import torch

from ndtpu.core import kl as jk
from ndtpu.core.ndt import ndt_downsample as jax_downsample
from ndtpu_torch.core import kl as tk
from ndtpu_torch.core.ndt import ndt_downsample

BIG = np.iinfo(np.int32).max


def random_spd(rng):
    a = rng.normal(size=(3, 3))
    return a @ a.T + 0.5 * np.eye(3)


def test_det_adjugate_match():
    ms = np.random.default_rng(0).normal(size=(32, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tk.det3(torch.from_numpy(ms)).numpy(),
                               np.asarray(jk.det3(jnp.asarray(ms))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tk.adjugate3(torch.from_numpy(ms)).numpy(),
                               np.asarray(jk.adjugate3(jnp.asarray(ms))),
                               rtol=1e-5, atol=1e-6)


def test_gaussian_kl_matches_including_masks():
    """Random SPD pairs, identical pairs (KL 0), and the singular and
    rank-deficient covariances the scale-aware mask rejects."""
    rng = np.random.default_rng(1)
    n = 24
    mp, mq = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    cp = np.stack([random_spd(rng) for _ in range(n)]).astype(np.float32)
    cq = np.stack([random_spd(rng) for _ in range(n)]).astype(np.float32)
    cq[3] = cp[3]
    mq[3] = mp[3]
    cp[5] = 0.0                                      # singular p
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    cq[7] = (q @ np.diag([3e-2, 1e-2, 0.0]) @ q.T).astype(np.float32)  # planar
    cp[9] = (q @ np.diag([4e-4, 1e-4, 0.5e-4]) @ q.T).astype(np.float32)  # tiny
    kl_j, ok_j = jk.gaussian_kl(*map(jnp.asarray, (mp, cp, mq, cq)))
    kl_t, ok_t = tk.gaussian_kl(*map(torch.from_numpy, (mp, cp, mq, cq)))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not ok_t[5] and not ok_t[7] and ok_t[9]
    assert abs(float(kl_t[3])) < 1e-4
    np.testing.assert_allclose(kl_t.numpy(), np.asarray(kl_j), rtol=1e-5,
                               atol=1e-5)


def _grid_case(rng, lens_np, occupancy, min_count):
    cells = np.array([(z, y, x) for z in range(lens_np[2])
                      for y in range(lens_np[1]) for x in range(lens_np[0])],
                     np.int32)
    occ = cells[rng.random(len(cells)) < occupancy]
    kk = len(occ)
    k = kk + 3
    zyx = np.full((k, 3), BIG, np.int32)
    zyx[:kk] = occ
    means = rng.normal(size=(k, 3)).astype(np.float32)
    covs = np.stack([random_spd(rng) * 0.1 for _ in range(k)]).astype(np.float32)
    counts = np.zeros(k, np.int32)
    counts[:kk] = rng.integers(min_count, 20, size=kk)
    return means, covs, counts, zyx, np.asarray(lens_np, np.int32)


def test_neighbor_min_kl_matches_payload_mode_batched():
    """Random occupied grids (with <=1-sample gating and one rank-one
    covariance), several clouds in one [B, K] call against the JAX payload
    mode cloud by cloud."""
    rng = np.random.default_rng(29)
    cases = [_grid_case(rng, (5, 4, 3), 0.55, 1) for _ in range(3)]
    cases[0][1][2] = np.outer([1.0, 2.0, 0.5], [1.0, 2.0, 0.5])
    k = min(len(c[0]) for c in cases)
    batch = [np.stack([c[i][:k] if i < 4 else c[i] for c in cases])
             for i in range(5)]
    # cut every cloud to the same K: drop the tail rows and re-pad
    for b in range(3):
        batch[3][b, -2:] = BIG
        batch[2][b, -2:] = 0
    mn_t, mx_t = tk.neighbor_min_kl(*map(torch.from_numpy, batch))
    for b in range(3):
        mn_j, mx_j = jk.neighbor_min_kl(*(jnp.asarray(a[b]) for a in batch))
        for got, ref in ((mn_t[b], mn_j), (mx_t[b], mx_j)):
            ref = np.asarray(ref)
            got = got.numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
            np.testing.assert_array_equal(np.sign(got), np.sign(ref))
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


def test_neighbor_min_kl_two_voxels_and_gating():
    rng = np.random.default_rng(3)
    means = np.zeros((1, 4, 3), np.float32)
    covs = np.zeros((1, 4, 3, 3), np.float32)
    means[0, 0], means[0, 1] = [0.5, 0.5, 0.5], [1.5, 0.5, 0.5]
    covs[0, 0] = random_spd(rng) * 0.01
    covs[0, 1] = random_spd(rng) * 0.01
    zyx = np.array([[[0, 0, 0], [0, 0, 1], [BIG] * 3, [BIG] * 3]], np.int32)
    lens = np.array([[2, 1, 1]], np.int32)
    for counts, defined in (([10, 10, 0, 0], True), ([10, 1, 0, 0], False)):
        c = np.array([counts], np.int32)
        mn, mx = tk.neighbor_min_kl(*map(torch.from_numpy,
                                         (means, covs, c, zyx, lens)))
        mn_j, _ = jk.neighbor_min_kl(*map(jnp.asarray,
                                          (means[0], covs[0], c[0], zyx[0],
                                           lens[0])))
        assert bool(torch.isfinite(mn[0, :2]).all()) == defined
        assert torch.isinf(mn[0, 2:]).all() and torch.isinf(mx[0, 2:]).all()
        np.testing.assert_allclose(mn[0].numpy(), np.asarray(mn_j), rtol=1e-5)


def test_prune_ranking_with_planar_voxel_matches():
    """tests/test_kl.py:313: a cloud holding an exactly planar cluster
    (rank-2 voxel covariance). The masked voxel must rank last in both
    packages, and the emitted clouds agree."""
    rng = np.random.default_rng(23)
    solid = rng.normal(size=(512, 3)).astype(np.float32)
    planar = np.stack([rng.uniform(-0.4, 0.4, 128), rng.uniform(-0.4, 0.4, 128),
                       np.zeros(128)], axis=1).astype(np.float32) + np.float32(4.0)
    pts = np.concatenate([solid, planar])
    a = jax_downsample(jnp.asarray(pts), 16)
    b = ndt_downsample(torch.from_numpy(pts)[None], 16)
    state = b[4]
    assert bool(torch.isinf(state.min_kl[0][state.counts[0] > 0]).any())
    np.testing.assert_array_equal(
        np.isinf(state.min_kl[0].numpy()), np.isinf(np.asarray(a[4].min_kl)))
    np.testing.assert_array_equal(b[3][0].numpy(), np.asarray(a[3]))
    np.testing.assert_allclose(b[0][0].numpy(), np.asarray(a[0]), rtol=1e-5,
                               atol=1e-6)
    again = ndt_downsample(torch.from_numpy(pts)[None], 16)
    for x, y in zip(b[:4], again[:4]):
        assert torch.equal(x, y)


def test_neighbor_min_kl_single_row():
    mn, mx = tk.neighbor_min_kl(torch.zeros(2, 1, 3), torch.zeros(2, 1, 3, 3),
                                torch.ones(2, 1, dtype=torch.int32),
                                torch.zeros(2, 1, 3, dtype=torch.int32),
                                torch.ones(2, 3, dtype=torch.int32))
    assert mn.shape == (2, 1) and torch.isinf(mn).all() and (mx < 0).all()
