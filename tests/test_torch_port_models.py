"""The port's models against flax, with the weights carried over by
``load_jax_variables``.

Logits are held to atol 1e-4 (as tests/test_torch_parity.py) plus rtol
1e-5: both sides sum the f32 matrix products in another order, so the
error grows with the logits' magnitude. ``batch_stats`` are moved away
from their initial 0/1 so that BatchNorm does real work.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.models import AdditionalFeatures as JaxExtra
from ndtpu.models import NDTNet as JaxNDTNet
from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu.models import TNet as JaxTNet
from ndtpu_torch.interop.jax_weights import load_jax_variables
from ndtpu_torch.models import AdditionalFeatures, NDTNet, NDTNetSegmentation, TNet
from ndtpu_torch.models.norm import BatchNorm


def perturbed(variables, seed):
    """numpy copy of a flax tree with batch_stats moved off 0/1."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.array, variables)

    def move(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                move(leaf)
            elif name == "mean":
                tree[name] = (leaf + rng.normal(scale=0.1, size=leaf.shape)
                              ).astype(np.float32)
            elif name == "var":
                tree[name] = (leaf * rng.uniform(0.5, 2.0, size=leaf.shape)
                              ).astype(np.float32)

    move(v["batch_stats"])
    return v


def inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    a = rng.normal(scale=0.3, size=(b, n, 3, 3))
    covs = (a @ np.swapaxes(a, -1, -2)).reshape(b, n, 9).astype(np.float32)
    return pts, covs


@pytest.mark.parametrize("num_classes,feature_dim", [(8, 128), (4, 32)])
def test_ndtnet_segmentation_matches_flax(num_classes, feature_dim):
    pts, covs = inputs(2, 48, 0)
    jm = JaxSegmentation(num_classes=num_classes, feature_dim=feature_dim)
    v = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(pts),
                          jnp.asarray(covs), train=False), 2)
    model = load_jax_variables(
        NDTNetSegmentation(num_classes=num_classes, feature_dim=feature_dim,
                           device="cpu"), v
    ).eval()
    t = torch.from_numpy
    for logits in (True, False):
        ref = np.asarray(jm.apply(v, jnp.asarray(pts), jnp.asarray(covs),
                                  train=False, return_logits=logits))
        with torch.no_grad():
            got = model(t(pts), t(covs), return_logits=logits).numpy()
        assert got.shape == (2, 48, num_classes + 1)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("extra", ["none", "feature_vector"])
def test_ndtnet_backbone_extra_features_match_flax(extra):
    """The backbone's other input layouts: points only, and points +
    covariances + a feature block riding along untransformed."""
    pts, covs = inputs(2, 24, 6)
    feats = np.random.default_rng(7).normal(size=(2, 24, 5)).astype(np.float32)
    jm = JaxNDTNet(feature_dim=32, extra_type=JaxExtra(extra))
    args = (jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(feats))
    v = perturbed(jm.init(jax.random.PRNGKey(8), *args), 9)
    model = load_jax_variables(
        NDTNet(feature_dim=32, extra_type=AdditionalFeatures(extra), extra_dim=5),
        v).eval()
    ref = jm.apply(v, *args)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (pts, covs, feats)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5)


def test_tnet_matches_flax():
    pts, _ = inputs(3, 40, 3)
    jt = JaxTNet(in_dim=3)
    v = perturbed(jt.init(jax.random.PRNGKey(4), jnp.asarray(pts)), 5)
    model = load_jax_variables(TNet(3), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.apply(v, jnp.asarray(pts))),
                               atol=1e-4, rtol=1e-5)


def test_batchnorm_is_eval_only_and_loader_checks_shapes():
    """Eval mode normalises with the running statistics; train mode (held
    against the JAX module in tests/test_torch_port_train.py) normalises
    with the batch's and moves the running ones. The loader refuses a
    model of other shapes."""
    bn = BatchNorm(4)
    y = bn(torch.full((2, 4), 3.0))
    assert torch.equal(y, torch.zeros(2, 4))
    torch.testing.assert_close(bn.running_mean, torch.full((4,), 0.3))
    torch.testing.assert_close(bn.running_var, torch.full((4,), 0.9))
    bn.running_var.fill_(1.0)
    x = torch.randn(5, 4)
    bn.eval().running_mean.fill_(0.5)
    torch.testing.assert_close(bn(x), (x - 0.5) / torch.sqrt(torch.tensor(1.0 + 1e-5)))
    jm = JaxSegmentation(num_classes=4, feature_dim=32)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 9)),
        train=False))
    with pytest.raises(ValueError):
        load_jax_variables(
            NDTNetSegmentation(num_classes=5, feature_dim=32, device="cpu"), v)
