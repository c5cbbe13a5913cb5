"""The whole serving slice: the port's SegmentationPipeline on the CPU
against the JAX package's ndt_preprocessing_with_state +
NDTNetSegmentation.apply, with the same weights (load_jax_variables).

out_mask must match exactly, logits to atol 1e-4 + rtol 1e-5 (f32 matrix
products summed in another order). Which NDs the prune keeps is exact
only when both sides round alike: a 2- or 3-point voxel has a
rank-deficient covariance whose singularity test is decided by rounding
noise, and under ``jit`` XLA fuses ``a - b * c`` into an FMA where torch
does not. So the entry-shape run takes the JAX preprocessing op by op
(``jax.disable_jit``), and the run against the Pallas kernel (whose
one-hot contraction sums in another order in any case) uses a cloud with
no such voxel, which the test checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _example_cloud
from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu.preprocessing.batch import ndt_preprocessing_with_state as jax_prep
from ndtpu_torch.data.synthetic import example_cloud, make_batch
from ndtpu_torch.interop.jax_weights import load_jax_variables
from ndtpu_torch.serve import SegmentationPipeline, entry


def jax_slice(points, m, c, f, use_pallas, eager):
    model = JaxSegmentation(num_classes=c, feature_dim=f)
    b = points.shape[0]
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((b, m, 3)),
                   jnp.zeros((b, m, 9)), train=False)
    if eager:
        with jax.disable_jit():
            prep = jax_prep(m, jnp.asarray(points), None, c, use_pallas,
                            "reference")
    else:
        prep = jax_prep(m, jnp.asarray(points), None, c, use_pallas, "reference")
    pcl, covs, _, mask, state = prep
    logits = model.apply(v, pcl, covs, train=False, return_logits=True)
    return (jax.tree_util.tree_map(np.asarray, v), np.asarray(logits),
            np.asarray(mask), state)


def port_slice(points, m, c, f, variables):
    pipe = SegmentationPipeline(m, c, f, search="reference", device="cpu")
    load_jax_variables(pipe.model, variables)
    logits, mask, state = pipe(points)
    return logits.numpy(), mask.numpy(), state


def test_whole_slice_matches_jax_at_entry_shape():
    """entry()'s small shape: B=2, N=4096, M=256, C=8, feature_dim 128."""
    b, n, m, c, f = 2, 4096, 256, 8, 128
    pts = _example_cloud(b, n)
    np.testing.assert_array_equal(example_cloud(b, n), pts)
    v, ref, ref_mask, jstate = jax_slice(pts, m, c, f, False, eager=True)
    logits, mask, state = port_slice(pts, m, c, f, v)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(state.num_valid.numpy(),
                                  np.asarray(jstate.num_valid))
    assert logits.shape == (b, m, c + 1)
    np.testing.assert_allclose(logits, ref, atol=1e-4, rtol=1e-5)


def test_whole_slice_matches_jax_pallas_path():
    """Against the JAX path that runs the Pallas moments kernel (interpret
    mode on the CPU), on a smaller cloud."""
    b, n, m, c, f = 2, 1024, 24, 8, 64
    pts = example_cloud(b, n, seed=5)
    v, ref, ref_mask, jstate = jax_slice(pts, m, c, f, True, eager=False)
    counts = np.asarray(jstate.counts)
    assert not np.isin(counts, (2, 3)).any()  # the prune is well posed
    logits, mask, state = port_slice(pts, m, c, f, v)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(state.counts.numpy(), counts)
    np.testing.assert_allclose(logits, ref, atol=1e-4, rtol=1e-5)


def test_entry_and_synthetic_batch_on_cpu():
    fn, (points,) = entry(device="cpu")
    assert points.shape == (2, 4096, 3) and points.device.type == "cpu"
    out = fn(points)
    assert out.shape == (2, 256, 9) and bool(torch.isfinite(out).all())
    from bench import make_batch as bench_make_batch

    np.testing.assert_array_equal(make_batch(2, 1000, seed=3),
                                  bench_make_batch(2, 1000, seed=3))
