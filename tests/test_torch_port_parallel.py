"""The port's point-sharded giant-cloud path and its two kernels (K2, K3)
against the JAX package.

- Plain versions of the kernels against the Pallas kernels in interpret
  mode: the tags kernel exactly (each segment sums one nonzero), the
  segment sum to atol 1e-4 (another summation order), and the port's
  ``segment_moments`` against JAX's ``use_pallas=True`` route.
- The sharded path on a one-rank gloo group against JAX on a 1-device
  ``points`` mesh with ``use_pallas=True``: integer outputs (voxel size
  under the reference search, counts, tables, masks) exact; pcl and covs
  to atol 2e-4, the psum tolerance of tests/test_sharding.py. The secant
  search uses log/pow, which torch need not reproduce to the last ulp:
  its accepted size is held to 1e-6.
- The collectives of one downsample, counted at ``torch.distributed``,
  against the structure of tests/test_collectives.py.
- Two gloo processes against JAX's 2-device mesh.

Each test creates and destroys its process group, so the workers of a
``--dist loadfile`` run stay clean.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from ndtpu.core import moments as jm
from ndtpu.core import ndt as jn
from ndtpu.core import voxel as jvx
from ndtpu.data.synthetic import clustered_cloud
from ndtpu.ops.pallas import segment_moments as jsm
from ndtpu.parallel import point_sharded as jps
from ndtpu.parallel.mesh import make_mesh
from ndtpu_torch.core import moments as tm
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.core import voxel as tvx
from ndtpu_torch.parallel import mesh as tmesh
from ndtpu_torch.parallel.collectives import Collectives
from ndtpu_torch.parallel import point_sharded as tps
from ndtpu_torch.ops import segment_moments as tsm

ROOT = pathlib.Path(__file__).resolve().parent.parent


def dense_ranks(n, k, rng):
    """Non-decreasing ids with unit steps (the kernels' precondition)."""
    steps = np.zeros(n, np.int32)
    pos = rng.choice(n - 1, size=min(k - 1, n - 1), replace=False) + 1
    steps[pos] = 1
    return np.cumsum(steps).astype(np.int32)


def cluster_cloud(seed, n_centers=40, per=26, n=1024, extent=6.0, scale=0.3):
    """The clouds of tests/test_sharding.py."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(n_centers, 3))
    pts = centers[:, None, :] + rng.normal(scale=scale,
                                           size=(n_centers, per, 3))
    return pts.reshape(-1, 3)[:n].astype(np.float32)


@pytest.fixture
def gloo():
    group = tmesh.make_group("cpu")
    yield group
    tmesh.release_group()


def one_device_mesh():
    return make_mesh(("points",), devices=np.asarray(jax.devices()[:1]))


# ---- the kernels' plain versions ----

@pytest.mark.parametrize("n,k,n_tags,dropped", [
    (2000, 77, 2, 5),     # tests/test_pallas.py:143
    (3000, 200, 4, 400),  # the pair table's four split columns
    (50, 50, 1, 0),       # one point per segment
])
def test_segment_tags_plain_matches_pallas(n, k, n_tags, dropped):
    rng = np.random.default_rng(11)
    seg = dense_ranks(n, k, rng)
    if dropped:
        seg[-dropped:] = k
    new = np.ones(n, bool)
    new[1:] = seg[1:] != seg[:-1]
    tags = [np.where(new, rng.integers(0, 1 << 12, n), 0).astype(np.float32)
            for _ in range(n_tags)]
    ref = jsm.segment_tags_sorted(jnp.asarray(seg),
                                  tuple(map(jnp.asarray, tags)), k)
    got = tsm.segment_tags_sorted(torch.from_numpy(seg),
                                  [torch.from_numpy(t) for t in tags], k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,k,f,block,dropped", [
    (1000, 37, 16, 128, 0),   # tests/test_pallas.py:21-48
    (513, 5, 42, 256, 0),     # N not a multiple of the block; F = 13 + 29
    (64, 40, 8, 512, 0),
    (300, 20, 4, 64, 40),     # the sentinel rows, dropped
])
def test_segment_sum_plain_matches_pallas(n, k, f, block, dropped):
    rng = np.random.default_rng(0)
    seg = dense_ranks(n, k, rng)
    if dropped:
        seg[-dropped:] = k
    feats = rng.normal(size=(n, f)).astype(np.float32)
    ref = jsm.segment_sum_sorted(jnp.asarray(feats), jnp.asarray(seg), k,
                                 block_n=block)
    got = tsm.segment_sum_sorted(torch.from_numpy(feats),
                                 torch.from_numpy(seg), k)
    assert got.shape == (k, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_kernel_wrappers_check_inputs_and_count_only_launches():
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(dense_ranks(100, 9, rng))
    feats = torch.from_numpy(rng.normal(size=(100, 5)).astype(np.float32))
    tag = torch.zeros(100)
    before = (tsm.segment_sum_sorted.launches,
              tsm.segment_tags_sorted.launches)
    tsm.segment_sum_sorted(feats, seg, 9)
    tsm.segment_tags_sorted(seg, [tag], 9)
    assert (tsm.segment_sum_sorted.launches,
            tsm.segment_tags_sorted.launches) == before  # CPU: plain versions
    with pytest.raises(TypeError):
        tsm.segment_sum_sorted(feats.double(), seg, 9)
    with pytest.raises(TypeError):
        tsm.segment_tags_sorted(seg.long(), [tag], 9)
    with pytest.raises(ValueError):
        tsm.segment_sum_sorted(feats.t().contiguous().t(), seg, 9)
    with pytest.raises(ValueError):
        tsm.segment_sum_sorted(feats, seg[:50], 9)
    with pytest.raises(ValueError):
        tsm.segment_tags_sorted(seg, [tag] * 9, 9)
    with pytest.raises(ValueError):
        tsm.segment_tags_sorted(seg[None], [tag[None]], 9)


def test_segment_moments_matches_jax_pallas_route():
    """core/moments.py::segment_moments (the K2 route) against JAX's
    use_pallas=True, with invalid rows, dropped ids and classes."""
    rng = np.random.default_rng(4)
    n, k, slots = 900, 31, 4
    seg = dense_ranks(n, k + 1, rng)  # the last run is id k: dropped
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    centers = np.round(pts * 2) / 2
    valid = rng.random(n) > 0.1
    cls = rng.integers(0, slots, n).astype(np.int32)
    ref = jm.segment_moments(jnp.asarray(pts), jnp.asarray(centers),
                             jnp.asarray(seg), k, valid=jnp.asarray(valid),
                             classes=jnp.asarray(cls), num_class_slots=slots,
                             use_pallas=True)
    got = tm.segment_moments(torch.from_numpy(pts), torch.from_numpy(centers),
                             torch.from_numpy(seg), k,
                             valid=torch.from_numpy(valid),
                             classes=torch.from_numpy(cls),
                             num_class_slots=slots)
    for name in ("counts", "class_hist"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))
    for name in ("sum_shift", "sum_outer"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4)


def test_unfused_fast_search_matches_jax():
    """ndt._search_voxel_size_fast with the point count, batched, against
    the JAX function cloud by cloud: in band, and the same size to 1e-6."""
    clouds = np.stack([cluster_cloud(s) for s in (5, 9)])
    t = torch.from_numpy(clouds)
    px, py, pz = (t[..., a].contiguous() for a in range(3))
    mask = torch.ones(px.shape, dtype=torch.bool)
    mins, maxs = tn._limits(px, py, pz, mask)
    size, done = tn._search_voxel_size_fast(
        24, mins, maxs, tn._point_count(px, py, pz, mask))
    for b, cloud in enumerate(clouds):
        c = jnp.asarray(cloud)
        jmins, jmaxs = jvx.pointcloud_limits(c)
        jsize, jdone = jn._search_voxel_size_fast(
            c[:, 0], c[:, 1], c[:, 2], jnp.ones(len(cloud), bool), 24,
            jmins, jmaxs)
        assert bool(done[b]) == bool(jdone)
        assert abs(float(size[b]) - float(jsize)) < 1e-6


# ---- the sharded path on one gloo rank ----

def test_sharded_moments_and_count_match_jax(gloo):
    """tests/test_sharding.py:99's cloud and grid."""
    rng = np.random.default_rng(2)
    n, k_max = 1024, 32
    centers = rng.uniform(-4, 4, size=(20, 3))
    pts = (centers[:, None, :] + rng.normal(scale=0.3, size=(20, 52, 3))
           ).reshape(-1, 3)[:n].astype(np.float32)
    mask = np.ones(n, bool)
    mask[::7] = False
    mins, maxs = pts[mask].min(0), pts[mask].max(0)
    jlens, joffs = jvx.estimate_voxel_grid(jnp.asarray(mins), jnp.asarray(maxs),
                                           jnp.float32(1.0))
    mesh = one_device_mesh()

    @jax.jit
    def reference(p, m, lens, offs):
        size = jnp.float32(1.0)
        return (jps.sharded_segment_moments(mesh, p, m, size, lens, offs,
                                            k_max, use_pallas=True),
                jps.sharded_count_occupied(mesh, p, m, size, lens, offs,
                                           k_max, use_pallas=True))

    ref, ref_count = reference(jnp.asarray(pts), jnp.asarray(mask), jlens,
                               joffs)

    size = torch.tensor(1.0)
    lens, offs = tvx.estimate_voxel_grid(torch.from_numpy(mins),
                                         torch.from_numpy(maxs), size)
    args = (torch.from_numpy(pts), torch.from_numpy(mask), size, lens, offs,
            k_max)
    got = tps.sharded_segment_moments(gloo, *args)
    count = tps.sharded_count_occupied(gloo, *args)
    assert int(count) == int(ref_count)
    for name in ("table", "counts", "class_hist", "num_valid"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)
    for name in ("sum_shift", "sum_outer"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=2e-4)


def jax_downsample(pts, n_desired, search="reference", devices=1):
    mesh = make_mesh(("points",), devices=np.asarray(jax.devices()[:devices]))
    sh = NamedSharding(mesh, P("points"))
    fn = jps.make_point_sharded_downsample(mesh, n_desired, use_pallas=True,
                                           search=search)
    n = len(pts)
    return fn(jax.device_put(jnp.asarray(pts), sh),
              jax.device_put(jnp.ones((n,), bool), sh),
              jax.device_put(jnp.zeros((n,), jnp.int32), sh))


def assert_downsample_matches(got, ref, exact_size=True):
    pcl, covs, labels, out_mask, state = got
    rpcl, rcovs, rlabels, rmask, rstate = ref
    if exact_size:
        assert float(state.voxel_size[0]) == float(rstate.voxel_size)
    else:
        assert abs(float(state.voxel_size[0]) - float(rstate.voxel_size)) < 1e-6
    assert bool(state.converged[0]) == bool(rstate.converged)
    for name in ("num_valid", "counts", "zyx", "class_hist"):
        np.testing.assert_array_equal(getattr(state, name)[0].numpy(),
                                      np.asarray(getattr(rstate, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rlabels))
    np.testing.assert_allclose(pcl.numpy(), np.asarray(rpcl), atol=2e-4)
    np.testing.assert_allclose(covs.numpy(), np.asarray(rcovs), atol=2e-4)


def test_downsample_reference_search_matches_jax(gloo):
    pts = cluster_cloud(5)
    got = tps.make_point_sharded_downsample(24, group=gloo)(
        torch.from_numpy(pts))
    assert got[0].shape == (24, 3) and got[1].shape == (24, 9)
    assert got[4].means.shape[0] == 1  # the state has a batch of one
    assert_downsample_matches(got, jax_downsample(pts, 24))


@pytest.mark.parametrize("search", ["fast", "probe"])
def test_downsample_fast_search_matches_jax(gloo, search):
    """"probe" is an alias of "fast" on the sharded path."""
    pts = cluster_cloud(9)
    got = tps.make_point_sharded_downsample(24, group=gloo, search=search)(
        torch.from_numpy(pts))
    state = got[4]
    assert bool(state.converged[0])
    assert 24 <= int(state.num_valid[0]) <= int(24 * 1.2)
    assert int(got[3].sum()) == 24
    assert_downsample_matches(got, jax_downsample(pts, 24, "fast"),
                              exact_size=False)
    # the single-device fast search accepts the same size
    single = tn.ndt_downsample(torch.from_numpy(pts)[None], 24,
                               search="fast")[4]
    assert abs(float(single.voxel_size[0] - state.voxel_size[0])) < 1e-6


def test_outlier_cloud_reports_unconverged(gloo):
    """tests/test_sharding.py:186: the packed-key clamp coarsens the
    accepted size, so converged flips to False."""
    rng = np.random.default_rng(23)
    pts = rng.uniform(0.0, 1.0, size=(4096, 3)).astype(np.float32)
    pts[-1] = [4000.0, 4000.0, 4000.0]
    got = tps.make_point_sharded_downsample(64, group=gloo)(
        torch.from_numpy(pts))
    assert not bool(got[4].converged[0])
    assert int(got[3].sum()) < 64


def test_golden_point_sharded_pins(gloo):
    """tests/test_golden.py:99's pins, on one rank."""
    pts = clustered_cloud(2000, n_clusters=32, extent=8.0, scale=0.3, seed=42)
    pcl, covs, labels, omask, state = tps.make_point_sharded_downsample(
        20, group=gloo)(torch.from_numpy(pts))
    assert float(state.voxel_size[0]) == np.float32(5.629374980926514)
    assert int(state.num_valid[0]) == 23
    assert bool(state.converged[0])
    assert int(omask.sum()) == 20
    np.testing.assert_allclose(float(pcl.sum()), 13.160667419433594,
                               rtol=1e-5)
    np.testing.assert_allclose(float(covs.sum()), 44.63232421875, rtol=1e-4)
    np.testing.assert_allclose(
        pcl[0].numpy(),
        [1.1183464527130127, -4.586442470550537, -6.656826496124268],
        rtol=1e-5)
    np.testing.assert_array_equal(state.counts[0, :8].numpy(),
                                  [137, 158, 126, 63, 21, 63, 109, 91])


def test_collectives_of_one_downsample(gloo, monkeypatch):
    """tests/test_collectives.py:89's structure, counted at
    torch.distributed: one [2, k_max] table all-gather per search
    evaluation; in the moment pass one [k_max] all-gather and one
    [k_max, 14] all-reduce; else only the [1, 6] limits reduce. Nothing
    moves O(N) point data."""
    n_points, n_desired = 4096, 64
    k_max = tn.max_segments(n_desired)
    evaluations = []
    count = tps.sharded_count_occupied

    def counted_count(*a, **kw):
        evaluations.append(1)
        return count(*a, **kw)

    monkeypatch.setattr(tps, "sharded_count_occupied", counted_count)
    pts = (np.random.default_rng(0).normal(size=(n_points, 3), scale=10.0)
           .astype(np.float32))
    with Collectives() as coll:
        tps.make_point_sharded_downsample(n_desired, group=gloo)(
            torch.from_numpy(pts))
    calls = [(c.op, c.shape, c.itemsize) for c in coll.log]
    e = len(evaluations)
    assert e >= 1
    assert sorted(calls) == sorted(
        [("all_gather", (2, k_max), 4)] * e + [("all_gather", (k_max,), 4)]
        + [("all_reduce", (1, 6), 4), ("all_reduce", (k_max, 14), 4)])
    moved = sum(np.prod(s) * b for _, s, b in calls if s != (2, k_max))
    assert moved + 2 * k_max * 4 < n_points * 3 * 4


# ---- two gloo processes ----

WORKER = r"""
import sys
import numpy as np
import torch
from ndtpu_torch.parallel import mesh
from ndtpu_torch.parallel.point_sharded import make_point_sharded_downsample

init, rank, src, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
pts = torch.from_numpy(np.load(src))
group = mesh.make_group("cpu", init_method=init, world_size=2, rank=rank)
try:
    pcl, covs, labels, m, st = make_point_sharded_downsample(24, group=group)(
        mesh.shard_points(pts, group))
finally:
    mesh.release_group()
np.savez(out, pcl=pcl.numpy(), covs=covs.numpy(), labels=labels.numpy(),
         mask=m.numpy(), voxel_size=st.voxel_size.numpy(),
         num_valid=st.num_valid.numpy(), counts=st.counts.numpy(),
         zyx=st.zyx.numpy())
"""


def test_two_gloo_ranks_match_jax_two_device_mesh(tmp_path):
    pts = cluster_cloud(5)
    np.save(tmp_path / "pts.npy", pts)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, f"file://{tmp_path / 'store'}",
         str(rank), str(tmp_path / "pts.npy"), str(tmp_path / f"r{rank}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    r0, r1 = (np.load(tmp_path / f"r{rank}.npz") for rank in (0, 1))
    for name in r0.files:  # replicated on both ranks
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    pcl, covs, labels, mask, state = jax_downsample(pts, 24, devices=2)
    assert float(r0["voxel_size"][0]) == float(state.voxel_size)
    assert int(r0["num_valid"][0]) == int(state.num_valid)
    np.testing.assert_array_equal(r0["counts"][0], np.asarray(state.counts))
    np.testing.assert_array_equal(r0["zyx"][0], np.asarray(state.zyx))
    np.testing.assert_array_equal(r0["mask"], np.asarray(mask))
    np.testing.assert_array_equal(r0["labels"], np.asarray(labels))
    np.testing.assert_allclose(r0["pcl"], np.asarray(pcl), atol=2e-4)
    np.testing.assert_allclose(r0["covs"], np.asarray(covs), atol=2e-4)


def test_group_helpers(gloo):
    assert dist.get_world_size(gloo) == 1
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(tmesh.shard_points(x, gloo), x)
    with pytest.raises(RuntimeError):
        tmesh.make_group("cpu")  # one default group at a time
