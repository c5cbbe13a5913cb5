"""The rest of the port's sampler against the JAX package: the grid
search, pair keys, the legacy_c prune and NDTSampler (the cases of
tests/test_ndt.py and tests/test_golden.py).

Comparisons follow tests/test_torch_port_ndt.py (its module docstring):
integers exact, means to rtol 1e-6, covariances to rtol 1e-5, KLs where
well posed, the emit exactly on the JAX state. The grid search places its
candidates with exp/log, which torch need not reproduce to the last ulp:
it is held to the acceptance band, then compared downstream at the JAX
package's accepted size through fixed_voxel_size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.core import ndt as jn
from ndtpu.data.synthetic import clustered_cloud
from ndtpu_torch.core import ndt as tn
from test_torch_port_ndt import assert_same_downsample, clusters, jax_ref, port, port_state


def grid_clouds():
    """tests/test_ndt.py::test_grid_search_lands_in_band's three clouds."""
    rng = np.random.default_rng(31)
    return np.stack([(rng.normal(size=(800, 3)) * (1.5 + s)).astype(np.float32)
                     for s in range(3)])


def outlier_cloud():
    """tests/test_ndt.py::_outlier_cloud: a dense 1 m cube plus one point
    4 km away on every axis."""
    rng = np.random.default_rng(23)
    pts = rng.uniform(0.0, 1.0, size=(4096, 3)).astype(np.float32)
    return np.concatenate([pts, np.array([[4000.0, 4000.0, 4000.0]], np.float32)])


def jax_sizes(batch, n, **kw):
    """The JAX package's accepted voxel size of each cloud."""
    return np.asarray(jax.vmap(
        lambda p: jn.ndt_downsample(p, n, **kw)[4].voxel_size)(jnp.asarray(batch)))


@pytest.mark.parametrize("key_mode", ["packed", "pair"])
def test_grid_search_lands_in_band_and_matches_at_jax_size(key_mode):
    """Acceptance (converged, count in [n, 1.2 n], exactly n kept, the
    same sizes as a second run), then the state and outputs at the JAX
    package's accepted sizes."""
    batch, n = grid_clouds(), 40
    pcl, covs, labels, mask, st = port(batch, n, search="grid",
                                       key_mode=key_mode)
    assert bool(st.converged.all())
    assert bool(((st.num_valid >= n) & (st.num_valid <= int(1.2 * n))).all())
    assert bool((mask.sum(-1) == n).all())
    assert torch.equal(port(batch, n, search="grid", key_mode=key_mode)[0], pcl)
    sizes = jax_sizes(batch, n, search="grid", key_mode=key_mode)
    np.testing.assert_allclose(st.voxel_size.numpy(), sizes, rtol=1e-5)
    got = port(batch, n, fixed_voxel_size=torch.tensor(sizes), key_mode=key_mode)
    for b in range(3):
        assert_same_downsample(got, jax_ref(
            batch[b], n, fixed_voxel_size=jnp.float32(sizes[b]),
            key_mode=key_mode), b)


@pytest.mark.parametrize("pair", [False, True])
def test_count_occupied_multi_matches_jax(pair):
    """The grid search's counts at G sizes from one sort: exact, on
    clustered clouds and on the outlier cloud (sizes below the packed
    envelope only where the pair key is asked for)."""
    batch = np.concatenate([clusters(1, 24, 40, 8.0, 0.3, 5)[0][:960],
                            outlier_cloud()[-960:]]).reshape(2, 960, 3)
    px, py, pz = (torch.from_numpy(np.ascontiguousarray(batch[..., a]))
                  for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool)
    mins, maxs = tn._limits(px, py, pz, mask)
    env = tn._envelope(mins, maxs, "pair" if pair else "packed")
    sizes = env[:, None] * torch.tensor([1.0, 1.5, 3.0, 10.0, 40.0, 400.0])
    got = tn._count_occupied_multi(px, py, pz, mask, sizes, mins, maxs)
    for b in range(2):
        ref = jn._count_occupied_multi(
            jnp.asarray(px[b].numpy()), jnp.asarray(py[b].numpy()),
            jnp.asarray(pz[b].numpy()), jnp.ones((960,), bool),
            jnp.asarray(sizes[b].numpy()), jnp.asarray(mins[b].numpy()),
            jnp.asarray(maxs[b].numpy()), pair=pair)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_pair_matches_packed_on_ordinary_cloud():
    """tests/test_ndt.py:287-293: on a cloud inside both envelopes the two
    key modes give the same outputs and state; and the pair mode against
    JAX's."""
    rng = np.random.default_rng(29)
    pts = (rng.normal(size=(512, 3)) * 2.0).astype(np.float32)
    a = port(pts[None], 24)
    b = port(pts[None], 24, key_mode="pair")
    for xa, xb in zip(a[:4], b[:4]):
        assert torch.equal(xa, xb)
    for name in ("voxel_size", "counts", "zyx", "means", "covs", "min_kl"):
        assert torch.equal(getattr(a[4], name), getattr(b[4], name)), name
    assert_same_downsample(b, jax_ref(pts, 24, key_mode="pair"))


@pytest.mark.parametrize("search", ["reference", "probe", "grid"])
@pytest.mark.parametrize("key_mode", ["packed", "pair"])
def test_outlier_cloud_semantics(search, key_mode):
    """tests/test_ndt.py:262-349: packed keys cannot reach the band (the
    cloud is reported unconverged, with as many NDs as occupied voxels);
    pair keys converge with exactly n, one of them the outlier itself
    (its grid is 4000 m / ~0.27 m ~ 15000 voxels an axis, far inside the
    2**24 at which the f32 tag columns stop being exact). The JAX package
    agrees on both, and the state and outputs match at its size."""
    pts, n = outlier_cloud(), 64
    got = port(pts[None], n, search=search, key_mode=key_mode)
    ref = jax_ref(pts, n, search=search, key_mode=key_mode)
    st, kept = got[4], int(got[3].sum())
    assert bool(st.converged[0]) == bool(ref[4].converged) == (key_mode == "pair")
    assert kept == int(np.asarray(ref[3]).sum())
    if key_mode == "pair":
        assert kept == n
        d = np.linalg.norm(got[0][0][got[3][0]].numpy() - 4000.0, axis=1)
        assert d.min() < 1e-2
        assert 2**12 < int(st.lens[0, 0]) < 2**24
    else:
        assert int(st.num_valid[0]) == kept < n
    if search == "reference":  # an exact trajectory: the same size
        assert_same_downsample(got, ref)
    else:
        size = float(ref[4].voxel_size)
        np.testing.assert_allclose(float(st.voxel_size[0]), size, rtol=1e-5)
        assert_same_downsample(
            port(pts[None], n, fixed_voxel_size=size, key_mode=key_mode),
            jax_ref(pts, n, fixed_voxel_size=jnp.float32(size),
                    key_mode=key_mode))


@pytest.mark.parametrize("kw,pins", [
    # tests/test_golden.py:55-57 (prune_order="legacy_c")
    (dict(prune_order="legacy_c"),
     (23, -4.361214637756348, 1e-5, 45.176876068115234, 1e-4)),
    # tests/test_golden.py:66-95 (key_mode="pair")
    (dict(key_mode="pair"), (23, 13.160667419433594, 1e-6, 44.63232421875, 1e-5)),
])
def test_golden_pins_hold_in_the_port(kw, pins):
    """The JAX package's golden pins for the legacy_c prune and for pair
    keys, met by the port on the same cloud at the pins' tolerances; then
    against the JAX outputs."""
    valid, pcl_sum, pcl_rtol, covs_sum, covs_rtol = pins
    pts = clustered_cloud(2000, n_clusters=32, extent=8.0, scale=0.3, seed=42)
    got = port(pts[None], 20, **kw)
    pcl, covs, _, mask, st = got
    assert float(st.voxel_size[0]) == np.float32(5.629374980926514)
    assert int(st.num_valid[0]) == valid
    assert bool(st.converged[0])
    assert int(mask.sum()) == 20
    np.testing.assert_allclose(float(pcl.sum()), pcl_sum, rtol=pcl_rtol)
    np.testing.assert_allclose(float(covs.sum()), covs_sum, rtol=covs_rtol)
    np.testing.assert_allclose(
        pcl[0, 0].numpy(),
        [1.1183464527130127, -4.586442470550537, -6.656826496124268], rtol=1e-6)
    assert_same_downsample(got, jax_ref(pts, 20, **kw),
                           prune_order=kw.get("prune_order", "ascending"))


def test_legacy_c_downsample_and_prune_match_jax():
    """prune_order="legacy_c" (the most divergent NDs go first) on a batch
    of clustered clouds, and ndt_prune to a coarser count in that order:
    the prune of the JAX state exactly, the port's own prune within the
    golden tolerances, its kept NDs a subset of the downsample's."""
    batch = clusters(2, 40, 25, 5.0, 0.3, 9)
    got = port(batch, 30, prune_order="legacy_c")
    for b in range(2):
        jref = jax_ref(batch[b], 30, prune_order="legacy_c")
        assert_same_downsample(got, jref, b, prune_order="legacy_c")
        jp, jc, jl, jm = jn.ndt_prune(jref[4], 20, "legacy_c")
        exact = tn.ndt_prune(port_state(jref[4]), 20, "legacy_c")
        for e, r in zip(exact, (jp, jc, jl, jm)):
            np.testing.assert_array_equal(e[0].numpy(), np.asarray(r))
    pcl2, covs2, _, mask2 = tn.ndt_prune(got[4], 20, "legacy_c")
    assert bool((mask2.sum(-1) == 20).all())
    for b in range(2):
        jp, jc, _, jm = jn.ndt_prune(jax_ref(batch[b], 30, prune_order="legacy_c")[4],
                                     20, "legacy_c")
        np.testing.assert_array_equal(mask2[b].numpy(), np.asarray(jm))
        np.testing.assert_allclose(pcl2[b].numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-6)
        fine = {tuple(r) for r in got[0][b][got[3][b]].numpy().round(4)}
        assert all(tuple(r) in fine for r in pcl2[b][mask2[b]].numpy().round(4))
    # the legacy order differs from the ascending one on this batch
    assert not torch.equal(port(batch, 30)[0], got[0])


def test_ndt_sampler_matches_jax_sampler():
    """NDTSampler on the CPU against the JAX package's on the same cloud
    (tests/test_ndt.py:222-232): float64 points and covariances, uint16
    labels, equal values; the prune's error beyond num_valid; prune before
    downsample refused."""
    from ndtpu.core.ndt import NDTSampler as JaxSampler

    rng = np.random.default_rng(19)
    pts = rng.normal(size=(300, 3)) * 3.0
    classes = rng.integers(0, 5, 300).astype(np.uint16)
    ours = tn.NDTSampler(pts, classes, num_classes=5, device="cpu")
    ref = JaxSampler(pts, classes, num_classes=5)
    with pytest.raises(RuntimeError):
        ours.prune(8)
    for got, want in ((ours.downsample(16), ref.downsample(16)),
                      (ours.prune(8), ref.prune(8))):
        for g, w, dtype in zip(got, want, (np.float64, np.float64, np.uint16)):
            assert g.dtype == w.dtype == dtype and g.shape == w.shape
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
    too_many = int(ours._state.num_valid[0]) + 1
    for sampler in (ours, ref):
        with pytest.raises(ValueError, match="greater than the number of valid"):
            sampler.prune(too_many)
    ours.cleanup()
    with pytest.raises(RuntimeError):
        ours.prune(8)


def test_ndt_sampler_is_exported_and_defaults_to_the_card(monkeypatch):
    """``from ndtpu_torch import NDTSampler`` gives the sampler of
    core/ndt.py, as ``from ndtpu import NDTSampler`` does in the JAX
    package; built without a device it asks for the card and raises where
    there is none."""
    import ndtpu_torch

    assert ndtpu_torch.NDTSampler is tn.NDTSampler
    assert "NDTSampler" in ndtpu_torch.__all__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ndtpu_torch.NDTSampler(np.zeros((8, 3)))
