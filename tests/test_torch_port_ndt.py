"""The port's batched ndt_downsample and preprocessing against the JAX
package (the cases of tests/test_golden.py and tests/test_ndt.py).

Each downsample is compared in two parts, the state (NDTResult) and the
emit. Integer outputs (voxel_size under the reference search, num_valid,
counts, zyx, class_hist, out_mask) must match exactly and means to rtol
1e-6. Under ``jit`` XLA contracts ``a - b * c`` into one FMA (the
covariance ``E[xx'] - m m'``, the voxel centres) where torch rounds the
product first, so covariances differ by a few ulps of the raw second
moment: rtol 1e-5 as tests/test_golden.py, plus atol 1e-6 * voxel_size**2.
The singularity test of a rank-deficient voxel (<= 3 points) is decided by
rounding noise in its determinant and may flip that voxel's KL between
defined and undefined, and inverting a near-singular covariance scales its
ulp differences by its condition number, so KLs are compared where
chip_smoke.well_posed holds (a voxel and its neighbours rest on >= 4
points with |det| > 1e-3 (tr/3)**3, the card check's rule), to 0.5 %. The
prune and the compaction are compared exactly by running the port's emit
on the JAX state.

The fast and probe searches use log/pow, which torch need not reproduce
to the last ulp: they are held to the acceptance band, then compared
downstream at the JAX package's accepted size through fixed_voxel_size.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import ndt as jn
from ndtpu.data.synthetic import clustered_cloud
from ndtpu.preprocessing.batch import ndt_preprocessing_with_state as jax_prep
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.preprocessing.batch import (
    ndt_preprocessing,
    ndt_preprocessing_with_state,
)

# the card check's rule for comparable KLs, at the repo's root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

CUBE16 = np.array(
    [
        [-1.0, 1.0, -1.0], [1.0, -1.0, -1.0], [1.0, 1.0, -1.0], [-1.0, -1.0, -1.0],
        [-1.0, 1.0, 1.0], [1.0, -1.0, 1.0], [1.0, 1.0, 1.0], [-1.0, -1.0, 1.0],
        [-0.5, 0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, -0.5, -0.5],
        [-0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, -0.5, 0.5],
    ],
    dtype=np.float32,
)
CUBE16_PERTURBED = CUBE16.copy()
CUBE16_PERTURBED[3, 0] = -1.01
CUBE16_PERTURBED[8, 2] = -0.51
CUBE16_PERTURBED[12, 1] = 0.48
CUBE16_PERTURBED[14, 1] = 0.52


def clusters(n_clouds, n_centers, per, extent, scale, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clouds):
        c = rng.uniform(-extent, extent, size=(n_centers, 3))
        pts = c[:, None, :] + rng.normal(scale=scale, size=(n_centers, per, 3))
        out.append(pts.reshape(-1, 3).astype(np.float32))
    return np.stack(out)


def port(points, n, **kw):
    """Port call on [B, N, 3] numpy points."""
    return tn.ndt_downsample(torch.from_numpy(points), n, **kw)


def jax_ref(points, n, **kw):
    """The JAX ndt_downsample of one [N, 3] cloud."""
    return jn.ndt_downsample(jnp.asarray(points), n, **kw)


def port_state(js):
    """A single-cloud JAX NDTResult as the port's [1, ...] NDTResult."""
    return tn.NDTResult(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))[None]
        for f in dataclasses.fields(tn.NDTResult)
    })


def assert_same_downsample(got, ref, b=0, prune_order="ascending"):
    """Cloud b of a port result against one JAX result (see the module
    docstring for the two parts), both pruned in ``prune_order``."""
    pcl, covs, labels, mask, st = got
    jp, jc, jl, jm, js = ref
    np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jm))
    vs = float(js.voxel_size)
    assert float(st.voxel_size[b]) == vs
    assert int(st.num_valid[b]) == int(js.num_valid)
    assert bool(st.converged[b]) == bool(js.converged)
    for name in ("counts", "zyx", "lens", "class_hist"):
        np.testing.assert_array_equal(getattr(st, name)[b].numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_allclose(st.means[b].numpy(), np.asarray(js.means),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.covs[b].numpy(), np.asarray(js.covs),
                               rtol=1e-5, atol=1e-6 * max(1.0, vs * vs))
    full = chip_smoke.well_posed(js.counts, js.zyx, js.covs).numpy()
    for name in ("min_kl", "max_kl"):
        a, r = getattr(st, name)[b].numpy()[full], np.asarray(getattr(js, name))[full]
        np.testing.assert_array_equal(np.isinf(a), np.isinf(r), err_msg=name)
        fin = np.isfinite(r)
        # KL inverts the covariance: its condition number scales up the
        # covariances' ulp differences
        np.testing.assert_allclose(a[fin], r[fin], rtol=5e-3, atol=1e-3,
                                   err_msg=name)
    emitted = tn._emit(port_state(js), len(np.asarray(jm)), prune_order)
    for e, r in zip(emitted, (jp, jc, jl, jm)):
        np.testing.assert_array_equal(e[0].numpy(), np.asarray(r))


def test_golden_pins_reference_search():
    """tests/test_golden.py:15-36 through the port, then against JAX."""
    pts = clustered_cloud(2000, n_clusters=32, extent=8.0, scale=0.3, seed=42)
    out = port(pts[None], 20)
    pcl, covs, labels, mask, st = out
    assert float(st.voxel_size[0]) == np.float32(5.629374980926514)
    assert int(st.num_valid[0]) == 23
    assert bool(st.converged[0])
    assert int(mask.sum()) == 20
    np.testing.assert_allclose(float(pcl.sum()), 13.160667419433594, rtol=1e-6)
    np.testing.assert_allclose(float(covs.sum()), 44.63232421875, rtol=1e-5)
    np.testing.assert_allclose(
        pcl[0, 0].numpy(),
        [1.1183464527130127, -4.586442470550537, -6.656826496124268], rtol=1e-6)
    np.testing.assert_array_equal(st.counts[0, :8].numpy(),
                                  [137, 158, 126, 63, 21, 63, 109, 91])
    assert_same_downsample(out, jax_ref(pts, 20))


@pytest.mark.parametrize("cloud,target", [
    (CUBE16, 8), (CUBE16, 4), (CUBE16_PERTURBED, 4), (CUBE16, 3),
    (CUBE16, 16),  # n_desired above the cloud's voxel count: K > N
])
def test_cube_cases_match(cloud, target):
    """tests/test_ndt.py's 16-point cube: 16 -> 8 converges, 16 -> 4
    cannot land in band (counts jump 8 -> 1) and the unconverged best
    guess plus the KL prune still emits exactly 4."""
    out = port(cloud[None], target)
    assert_same_downsample(out, jax_ref(cloud, target))
    if target == 4:
        assert not bool(out[4].converged[0]) and int(out[4].num_valid[0]) == 8
        assert int(out[3].sum()) == 4


def test_batched_reference_search_matches_per_cloud():
    """Clouds of different scales follow different bisection trajectories
    in one batched call; each must match its own JAX run."""
    rng = np.random.default_rng(17)
    batch = (rng.normal(size=(3, 200, 3)).astype(np.float32)
             * np.float32([1.0, 2.0, 4.0])[:, None, None])
    out = port(batch, 12)
    for b in range(3):
        assert_same_downsample(out, jax_ref(batch[b], 12), b)


def test_mask_excludes_padding_points():
    rng = np.random.default_rng(13)
    real = rng.normal(size=(80, 3)).astype(np.float32)
    pts = np.concatenate([real, np.full((20, 3), 1e6, np.float32)])
    mask = np.array([True] * 80 + [False] * 20)
    got = port(pts[None], 10, mask=torch.from_numpy(mask)[None])
    assert_same_downsample(got, jax_ref(pts, 10, mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(got[0][0].numpy(), port(real[None], 10)[0][0].numpy())


def test_outlier_cloud_reports_unconverged():
    """A dense 1 m cluster plus a 4 km outlier: the packed-key envelope
    binds, the cloud is reported unconverged with fewer NDs than asked."""
    rng = np.random.default_rng(23)
    pts = np.concatenate([rng.uniform(0.0, 1.0, size=(4096, 3)),
                          [[4000.0, 4000.0, 4000.0]]]).astype(np.float32)
    got = port(pts[None], 64)
    assert not bool(got[4].converged[0])
    assert int(got[4].num_valid[0]) == int(got[3].sum()) < 64
    assert_same_downsample(got, jax_ref(pts, 64))
    # a fixed size below the envelope is clamped and flagged
    assert not bool(port(pts[None], 64, fixed_voxel_size=0.3)[4].converged[0])
    assert bool(port(pts[None], 64, fixed_voxel_size=8.0)[4].converged[0])


def test_prune_prefix_property_and_ndt_prune_match():
    pts = clusters(1, 40, 25, 5.0, 0.3, 9)
    pcl1, _, _, mask1, state = port(pts, 30)
    pcl2, covs2, labels2, mask2 = tn.ndt_prune(state, 20)
    assert int(mask2.sum()) == 20
    fine = {tuple(np.round(r, 4)) for r in pcl1[0][mask1[0]].numpy()}
    for row in pcl2[0][mask2[0]].numpy():
        assert tuple(np.round(row, 4)) in fine
    jstate = jax_ref(pts[0], 30)[4]
    jp, jc, jl, jm = jn.ndt_prune(jstate, 20)
    np.testing.assert_array_equal(mask2[0].numpy(), np.asarray(jm))
    np.testing.assert_allclose(pcl2[0].numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


def test_class_majority_vote_matches():
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(loc=(0, 0, 0), scale=0.1, size=(30, 3)),
                          rng.normal(loc=(5, 5, 5), scale=0.1, size=(30, 3))]
                         ).astype(np.float32)
    classes = np.array([2] * 30 + [7] * 30, np.int32)
    got = port(pts[None], 2, classes=torch.from_numpy(classes)[None],
               num_class_slots=9)
    assert sorted(got[2][0][got[3][0]].tolist()) == [2, 7]
    assert_same_downsample(got, jax_ref(pts, 2, classes=jnp.asarray(classes),
                                        num_class_slots=9))


@pytest.mark.parametrize("search", ["fast", "probe"])
def test_searches_land_in_band_and_match_at_jax_size(search):
    """Acceptance: every cloud converges with a count in [n, 1.2 n] and
    emits exactly n. Then the downstream outputs at the JAX package's
    accepted size (fixed_voxel_size) must equal the JAX outputs."""
    batch = clusters(3, 24, 40, 8.0, 0.3, 5)
    n = 48
    pcl, covs, labels, mask, st = port(batch, n, search=search)
    assert bool(st.converged.all())
    assert bool(((st.num_valid >= n) & (st.num_valid <= int(1.2 * n))).all())
    assert bool((mask.sum(-1) == n).all())
    again = port(batch, n, search=search)
    assert torch.equal(pcl, again[0])
    sizes = np.asarray(jax.vmap(
        lambda p: jn.ndt_downsample(p, n, search=search)[4].voxel_size
    )(jnp.asarray(batch)))
    np.testing.assert_allclose(st.voxel_size.numpy(), sizes, rtol=1e-5)
    got = port(batch, n, fixed_voxel_size=torch.tensor(sizes))
    for b in range(3):
        assert_same_downsample(
            got, jax_ref(batch[b], n, fixed_voxel_size=jnp.float32(sizes[b])), b)
    # a warm start at an accepted size is accepted at its first evaluation
    warm = port(batch, n, search=search, warm_start_size=st.voxel_size)
    assert torch.equal(warm[4].voxel_size, st.voxel_size)
    assert torch.equal(warm[0], pcl)


def test_search_internals_match_jax():
    """The envelopes, the probe's seed and the fused search's carried sort
    on single clouds."""
    batch = clusters(2, 24, 40, 8.0, 0.3, 6)
    n = 48
    px, py, pz = (torch.from_numpy(np.ascontiguousarray(batch[..., a]))
                  for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool)
    mins, maxs = tn._limits(px, py, pz, mask)
    env = tn._min_packable_voxel_size(mins, maxs)
    probe = tn._probe_seed_size(px, py, pz, mask, n, mins, maxs, env)
    for b in range(2):
        p = jnp.asarray(batch[b])
        jmins, jmaxs = p.min(0), p.max(0)
        np.testing.assert_array_equal(mins[b].numpy(), np.asarray(jmins))
        jenv = jn._min_packable_voxel_size(jmins, jmaxs)
        np.testing.assert_allclose(float(env[b]), float(jenv), rtol=1e-6)
        np.testing.assert_allclose(
            float(tn._min_pair_packable_voxel_size(mins, maxs)[b]),
            float(jn._min_pair_packable_voxel_size(jmins, jmaxs)), rtol=1e-6)
        jprobe = jn._probe_seed_size(p[:, 0], p[:, 1], p[:, 2],
                                     jnp.ones(p.shape[0], bool), n, jmins,
                                     jmaxs, jenv)
        np.testing.assert_allclose(float(probe[b]), float(jprobe), rtol=1e-5)
    size, conv, cols = tn._search_and_sort_fast(
        px, py, pz, mask, torch.zeros(px.shape, dtype=torch.int32), n, mins,
        maxs, env, tagged=False)
    assert torch.equal(cols[0], torch.sort(cols[0], dim=-1).values)
    resorted = tn._sort_payload_at(px, py, pz, mask, None, size, mins, maxs,
                                   tagged=False)
    for c, r in zip(cols, resorted):
        assert torch.equal(c, r)


def test_empty_state_matches_downsample_shapes():
    pts = torch.from_numpy(clusters(2, 8, 12, 3.0, 0.3, 1))
    for slots in (1, 5):
        st = tn.ndt_downsample(pts, 24, classes=torch.zeros(pts.shape[:2],
                                                            dtype=torch.int32),
                               num_class_slots=slots)[4]
        tmpl = tn.empty_state(24, slots, batch=2, device="cpu")
        for f in ("means", "covs", "counts", "class_hist", "zyx", "min_kl",
                  "max_kl", "lens", "offsets", "voxel_size", "num_valid",
                  "converged"):
            a, b = getattr(st, f), getattr(tmpl, f)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), f


@pytest.mark.parametrize("tagging", ["none", "int", "onehot"])
def test_preprocessing_with_state_batched(tagging):
    """ndt_preprocessing_with_state on [3, N] against the JAX vmapped one:
    untagged (the serving path), integer tags and one-hot ground truth."""
    b, n, m, c = 3, 512, 24, 4
    clouds = np.stack([clustered_cloud(n, n_clusters=12, extent=5.0, scale=0.3,
                                       seed=7 + i) for i in range(b)])
    labels = (np.arange(b * n).reshape(b, n) * 2654435761 % (c + 1)).astype(np.int32)
    gt_t = gt_j = None
    if tagging == "int":
        gt_t, gt_j = torch.from_numpy(labels), jnp.asarray(labels)
    elif tagging == "onehot":
        oh = np.eye(c + 1, dtype=np.float32)[labels]
        gt_t, gt_j = torch.from_numpy(oh), jnp.asarray(oh)
    got = ndt_preprocessing_with_state(m, torch.from_numpy(clouds), gt_t, c)
    ref = jax_prep(m, jnp.asarray(clouds), gt_j, c)
    labels_t = got[2].argmax(-1)
    for i in range(b):
        js = jax.tree_util.tree_map(lambda a: a[i], ref[4])
        jl = np.asarray(ref[2][i]).argmax(-1)
        assert_same_downsample((got[0], got[1], labels_t, got[3], got[4]),
                               (ref[0][i], ref[1][i], jl, ref[3][i], js), i)
    assert got[2].shape == (b, m, c + 1)
    assert torch.equal(got[2].sum(-1), got[3].float())
    pcl, covs, onehot = ndt_preprocessing(m, torch.from_numpy(clouds), gt_t, c)
    assert torch.equal(pcl, got[0]) and (onehot is None) == (gt_t is None)
