"""The port's training slice on the CPU against the JAX package: train-mode
BatchNorm, the segmentation model in train mode, loss, accuracy, the
learning-rate schedule, gradients, Adam, the train state carried across,
the whole step over 3 steps, streaming, checkpoints and the trainer CLI.

Inputs come from a numpy seed at a small size (B = 4, N = 1024, M = 16,
C = 4, feature_dim 32). The JAX side takes its XLA route
(``use_pallas=False``), as its own CPU tests do. Whole-step comparisons
use the reference search (exact f32 bisection on both sides) on clouds
without a 2- or 3-point voxel, which the tests assert: the singularity
test of such a voxel is decided by rounding noise (ROADMAP.md, faults).

Adam's first update is lr * g / |g|: a gradient that is zero but for f32
noise (the bias of every Linear in front of a BatchNorm, which the norm
subtracts away) moves its parameter by +-lr in either framework, in
either direction. Those biases do not change a train-mode loss, so the
losses are compared over whole steps, and parameters are compared where
their gradient is not noise: |g| >= 1e-6 * max|g| of the leaf, and leaves
whose largest gradient is below 1e-6 of the model's largest are skipped.
"""
import copy
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ndtpu.data.loader import batch_iterator as jax_batch_iterator
from ndtpu.data.synthetic import SyntheticSeg as JaxSyntheticSeg
from ndtpu.models import NDTNetSegmentation as JaxSegmentation
from ndtpu.models.norm import BatchNorm as JaxBatchNorm
from ndtpu.preprocessing.batch import ndt_preprocessing_with_state as jax_prep
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch.data.loader import CachedDataset, batch_iterator, prefetch_to_device
from ndtpu_torch.data.synthetic import SyntheticSeg, example_cloud
from ndtpu_torch.interop.jax_weights import _pairs, load_jax_train_state, load_jax_variables
from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.tools._common import make_dataset
from ndtpu_torch.train import loop
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.state import (
    create_train_state,
    restore_checkpoint,
    save_checkpoint,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, M, C, F = 4, 1024, 16, 4, 32
LR = 0.01


def clouds(seed):
    """[B, N, 3] clouds, ``example_cloud`` (32 clusters) of the seeds
    SEEDS[seed], and int labels [B, N] in 1..4 by the signs of x and y.
    Four clouds that differ: BatchNorm over the B rows of a TNet's FC
    layers divides by their spread, which near-copies, or only two
    clouds, make ill-conditioned in f32 (at B = 2 the train-mode logits of
    either framework lie up to ~0.1 from a float64 evaluation). No cloud
    here has a 2- or 3-point voxel at M = 16."""
    pts = np.stack([example_cloud(1, N, seed=s)[0] for s in SEEDS[seed]])
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    return pts, labels


SEEDS = {1: (1, 5, 6, 7), 5: (8, 9, 10, 21), 6: (22, 26, 29, 1),
         7: (5, 7, 9, 21), 8: (6, 8, 10, 22), 9: (26, 29, 5, 6)}


def jax_state(lr=LR, seed=0):
    model = JaxSegmentation(num_classes=C, feature_dim=F)
    sched = jloop.make_lr_schedule(lr, steps_per_epoch=2)
    return jax_create_train_state(
        model, optax.adam(sched), jax.random.PRNGKey(seed),
        jnp.zeros((B, M, 3)), jnp.zeros((B, M, 9)),
        init_kwargs={"train": False})


def port_state(js, lr=LR):
    """The port's TrainState with the JAX state's weights, Adam moments and
    step."""
    state = create_train_state(C, F, loop.make_lr_schedule(lr, 2),
                               device="cpu")
    return load_jax_train_state(state, jax.tree_util.tree_map(np.asarray, js))


def prep_numpy(pts, labels):
    """The JAX preprocessing (reference search) as numpy; asserts that no
    kept voxel holds 2 or 3 points."""
    pcl, covs, gt, mask, st = jax_prep(M, jnp.asarray(pts), jnp.asarray(labels),
                                       C, False, "reference")
    counts = np.asarray(st.counts)
    assert not ((counts == 2) | (counts == 3)).any()
    return tuple(np.asarray(a) for a in (pcl, covs, gt, mask))


def flat_grads(model, tree):
    """[(name, port tensor, flax leaf)] over the parameters of the
    mapping."""
    named = {id(p): n for n, p in model.named_parameters()}
    return [(named[id(t)], t, np.asarray(a))
            for t, a in _pairs(model, tree, None)]


def signal(g, gmax_model):
    """Entries whose gradient is not f32 noise (see the module docstring)."""
    gmax = np.abs(g).max()
    if gmax < 1e-6 * gmax_model:
        return np.zeros(g.shape, bool)
    return np.abs(g) >= 1e-6 * gmax


# ---- BatchNorm, model, loss, schedule ----

@pytest.mark.parametrize("shape", [(2, 40, 8), (6, 8)])
def test_batchnorm_train_mode_matches_jax(shape):
    """Outputs, gradients (input, scale, bias) and the updated running
    statistics against BatchNorm(use_running_average=False), at [B, N, C]
    and at [B, C] (the TNet FC norms): rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    jbn = JaxBatchNorm(use_running_average=False)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 2, c).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=c).astype(np.float32))}
    stats = {"mean": jnp.asarray(rng.normal(size=c).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, c).astype(np.float32))}

    def f(p, xx):
        y, mut = jbn.apply({"params": p, "batch_stats": stats}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y_ref, new_stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), **tol)


def test_segmentation_train_forward_matches_jax():
    """Train-mode logits (atol 1e-4 + rtol 1e-5, as the eval-mode model
    tests) and every mutated batch_stats leaf (rtol 1e-4, atol 1e-5), from
    the same weights."""
    pcl, covs, _, _ = prep_numpy(*clouds(1))
    js = jax_state()
    logits, mut = jax.jit(functools.partial(
        js.apply_fn, train=True, return_logits=True, mutable=["batch_stats"]))(
        {"params": js.params, "batch_stats": js.batch_stats},
        jnp.asarray(pcl), jnp.asarray(covs))
    state = port_state(js)
    got = state.model.train()(torch.from_numpy(pcl), torch.from_numpy(covs),
                              return_logits=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-5)
    ref = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    stats = list(_pairs(state.model, jax.tree_util.tree_map(np.asarray, js.params),
                        ref))
    buffers = [(t, a) for t, a in stats if not isinstance(t, torch.nn.Parameter)]
    assert len(buffers) == 2 * 16  # 16 BatchNorms: mean and var each
    for t, a in buffers:
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_accuracy_match_jax(masked):
    """Loss within rtol 1e-6; accuracy exact, ties in the logits included
    (argmax takes the first maximum on both sides)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 9, 5)).astype(np.float32)
    logits[0, :3] = 1.0  # ties
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 9))]
    mask = rng.random((2, 9)) > 0.3 if masked else None
    args = [logits, onehot] + ([mask] if masked else [])
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(float(loop.cross_entropy_loss(*targs)),
                               float(jloop.cross_entropy_loss(*jargs)), rtol=1e-6)
    assert float(loop.accuracy(*targs)) == float(jloop.accuracy(*jargs))
    if masked:  # an empty mask divides by 1
        none = torch.zeros((2, 9), dtype=torch.bool)
        assert float(loop.cross_entropy_loss(targs[0], targs[1], none)) == 0.0


def test_lr_schedule_matches_optax():
    """Exact (float32, as optax evaluates it) at counts 0, 199, 200, 400."""
    ours = loop.make_lr_schedule(0.034, 10, 20, 0.5)
    ref = jloop.make_lr_schedule(0.034, 10, 20, 0.5)
    for count in (0, 199, 200, 400):
        assert ours(count) == float(ref(count)), count
    assert loop.make_lr_schedule(0.1, 0)(5) == float(jloop.make_lr_schedule(0.1, 0)(5))


# ---- gradients, Adam, the state carried across, whole steps ----

def test_gradients_and_adam_update_match_jax():
    """On the same preprocessed batch: the loss (rtol 1e-5); every
    gradient leaf (leaves of noise excepted, see the module docstring)
    within 2e-2 of its largest |g| of JAX's jitted gradients, and within
    1e-3 of the same model's float64 gradients; the port's float64 twin
    within 1e-8 of each leaf's largest of JAX's float64 gradients (the
    same loss_fn in float64, noise leaves skipped); and one Adam update from
    JAX's own gradients against optax's (atol 1e-6: one f32 rounding of
    parameters of order 1). XLA reassociates the jitted gradient program:
    on this batch JAX's gradients lie up to 1.6e-2 (of a leaf's largest)
    from the float64 evaluation, the port's within 1e-4."""
    pcl, covs, gt, mask = prep_numpy(*clouds(5))
    js = jax_state()

    def loss_fn(params):
        logits, mut = js.apply_fn({"params": params, "batch_stats": js.batch_stats},
                                  jnp.asarray(pcl), jnp.asarray(covs), train=True,
                                  return_logits=True, mutable=["batch_stats"])
        return jloop.cross_entropy_loss(logits, jnp.asarray(gt), jnp.asarray(mask))

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(js.params)
    state = port_state(js)
    twin = copy.deepcopy(state.model).double()
    for model, dtype in ((state.model, torch.float32), (twin, torch.float64)):
        logits = model.train()(torch.from_numpy(pcl).to(dtype),
                               torch.from_numpy(covs).to(dtype),
                               return_logits=True)
        loss = loop.cross_entropy_loss(logits, torch.from_numpy(gt).to(dtype),
                                       torch.from_numpy(mask))
        loss.backward()
        if dtype == torch.float32:
            np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)

    leaves = flat_grads(state.model, jax.tree_util.tree_map(np.asarray, grads))
    g64 = dict(twin.named_parameters())
    gmax_model = max(np.abs(g).max() for _, _, g in leaves)
    compared = 0
    for name, p, g in leaves:
        keep = signal(g, gmax_model)
        if keep.any():
            ours = p.grad.numpy()
            assert np.abs(ours - g)[keep].max() <= 2e-2 * np.abs(g).max(), name
            exact = g64[name].grad.numpy()
            assert (np.abs(ours - exact)[keep].max()
                    <= 1e-3 * np.abs(exact).max()), name
            compared += 1
    assert compared > len(leaves) // 2

    # float64 on both sides ties the port's backward to JAX's apart from
    # f32 rounding: every leaf that is not noise within 1e-8 of its largest
    with jax.enable_x64(True):
        model64 = JaxSegmentation(num_classes=C, feature_dim=F,
                                  dtype=jnp.float64, param_dtype=jnp.float64)
        to64 = functools.partial(jax.tree_util.tree_map,
                                 lambda a: jnp.asarray(np.asarray(a, np.float64)))
        stats64 = to64(js.batch_stats)

        def loss64(params):
            logits, _ = model64.apply(
                {"params": params, "batch_stats": stats64},
                jnp.asarray(pcl, jnp.float64), jnp.asarray(covs, jnp.float64),
                train=True, return_logits=True, mutable=["batch_stats"])
            return jloop.cross_entropy_loss(logits, jnp.asarray(gt, jnp.float64),
                                            jnp.asarray(mask))

        grads64 = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss64))(to64(js.params)))
    leaves64 = [(name, g64[name].grad.numpy(), g)
                for name, _, g in flat_grads(twin, grads64)]
    assert all(g.dtype == np.float64 for _, _, g in leaves64)
    gmax64 = max(np.abs(g).max() for _, _, g in leaves64)
    compared = 0
    for name, ours, g in leaves64:
        if np.abs(g).max() >= 1e-6 * gmax64:
            assert np.abs(ours - g).max() <= 1e-8 * np.abs(g).max(), name
            compared += 1
    assert compared > len(leaves64) // 2

    # Adam given the same gradients: the port's optimizer against optax
    for _, p, g in leaves:
        p.grad = torch.from_numpy(np.ascontiguousarray(g))
    state.apply_gradients()
    new = js.apply_gradients(grads)
    for name, p, a in flat_grads(state.model,
                                 jax.tree_util.tree_map(np.asarray, new.params)):
        np.testing.assert_allclose(p.detach().numpy(), a, atol=1e-6, rtol=0,
                                   err_msg=name)
    assert state.step == int(new.step) == 1


def test_port_continues_a_jax_train_state():
    """JAX takes 2 steps; load_jax_train_state carries its weights, BN
    statistics, Adam moments and step into the port. The port's 3rd step
    gives JAX's 3rd step's loss (rtol 1e-5) and running statistics (rtol
    1e-4, atol 1e-5); and given JAX's 3rd-step gradients, the port's Adam,
    resuming from the carried moments and count, lands on optax's
    parameters (atol 1e-6)."""
    pts, labels = clouds(6)
    prep_numpy(pts, labels)
    step_j, _ = jloop.make_ndt_seg_step(M, C, False, "reference")
    js = jax_state()
    for _ in range(2):
        js, _ = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
    state = port_state(js)
    assert state.step == 2
    assert all(float(s["step"]) == 2 for s in state.optimizer.state.values())
    js3, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
    step, _ = loop.make_ndt_seg_step(M, C, "reference")
    state, m = step(state, torch.from_numpy(pts), torch.from_numpy(labels))
    assert state.step == 3
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
    assert abs(float(m["accuracy"]) - float(m_ref["accuracy"])) <= 1 / (B * M)
    np_params = jax.tree_util.tree_map(np.asarray, js3.params)
    stats = jax.tree_util.tree_map(np.asarray, js3.batch_stats)
    for t, a in _pairs(state.model, np_params, stats):
        if not isinstance(t, torch.nn.Parameter):
            np.testing.assert_allclose(t.numpy(), a, rtol=1e-4, atol=1e-5)

    again = port_state(js)
    grads = step_grads(js, pts, labels)
    for _, p, g in flat_grads(again.model, grads):
        p.grad = torch.from_numpy(np.ascontiguousarray(g))
    again.apply_gradients()
    ref = js.apply_gradients(grads)
    for name, p, a in flat_grads(again.model,
                                 jax.tree_util.tree_map(np.asarray, ref.params)):
        np.testing.assert_allclose(p.detach().numpy(), a, atol=1e-6, rtol=0,
                                   err_msg=name)
    assert again.step == int(ref.step) == 3


def step_grads(js, pts, labels):
    """JAX's gradients (numpy) of a train step at state js: the loss_fn
    that make_ndt_seg_step builds, reference search."""
    pcl, covs, gt, mask, _ = jax_prep(M, jnp.asarray(pts), jnp.asarray(labels),
                                      C, False, "reference")

    def loss_fn(params):
        logits, _ = js.apply_fn({"params": params, "batch_stats": js.batch_stats},
                                pcl, covs, train=True, return_logits=True,
                                mutable=["batch_stats"])
        return jloop.cross_entropy_loss(logits, gt, mask)

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(js.params))


def test_whole_step_matches_make_ndt_seg_step_over_3_steps():
    """The port's step (its own preprocessing, int labels) against JAX's
    jitted make_ndt_seg_step from the same weights, at lr 1e-3: the first
    loss within rtol 1e-5 and the accuracy within one ND; the next two
    losses, and the eval loss after them, within rtol 5e-2. From the
    second step on, f32 rounding decides the direction of Adam's update
    wherever a gradient is noise (module docstring): the port's own f32
    step drifts from its float64 twin as far (relative loss differences
    of 1e-5 to 4e-2 at steps 2-3 on these clouds)."""
    pts, labels = clouds(7)
    prep_numpy(pts, labels)
    step_j, eval_j = jloop.make_ndt_seg_step(M, C, False, "reference")
    js = jax_state(lr=1e-3)
    state = port_state(js, lr=1e-3)
    step, eval_step = loop.make_ndt_seg_step(M, C, "reference")
    tp, tl = torch.from_numpy(pts), torch.from_numpy(labels)
    for i in range(3):
        js, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
        state, m = step(state, tp, tl)
        assert m["loss"].dim() == 0 and m["loss"].device.type == "cpu"
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5 if i == 0 else 5e-2,
                                   err_msg=f"step {i}")
        if i == 0:
            assert abs(float(m["accuracy"]) - float(m_ref["accuracy"])) <= 1 / (B * M)
    e_ref = eval_j(js, jnp.asarray(pts), jnp.asarray(labels))
    e = eval_step(state, tp, tl)
    np.testing.assert_allclose(float(e["loss"]), float(e_ref["loss"]), rtol=5e-2)
    assert state.step == int(js.step) == 3


def test_eval_losses_after_two_steps_at_lr_0034_match_jax_in_magnitude():
    """The trainer's full-width eval losses (~1e8-1e10 after 2 steps at lr
    0.034) are the model's behaviour: at feature_dim 768 and lr 0.034, on
    B = 4 uniform clouds of N = 2048 points (random_cloud, no 2- or
    3-point voxel at M = 64) with 28 classes, JAX's make_ndt_seg_step and
    the port each take 2 steps from the same weights, then evaluate 4 other
    clouds. The train losses agree within rtol 5e-2; both eval losses are
    huge and within a factor of 10 of each other (Adam's first updates are
    +-lr on f32-noise gradients, and in eval mode the biases in front of
    each BatchNorm shift the activations, so the values themselves differ);
    and the port's eval step on JAX's state, carried over, gives JAX's
    eval loss within rtol 1e-5."""
    from ndtpu_torch.data.synthetic import random_cloud

    b, n, m, c, f, lr = 4, 2048, 64, 28, 768, 0.034

    def batch(seeds):
        pts = np.stack([random_cloud(n, 10.0, seed=s) for s in seeds])
        labels = (1 + (pts[..., 0] > 5) + 2 * (pts[..., 1] > 5)).astype(np.int32)
        return pts, labels

    train, val = batch((0, 1, 2, 3)), batch((4, 5, 6, 7))
    for pts in (train[0], val[0]):
        counts = np.asarray(jax_prep(m, jnp.asarray(pts), None, c, False,
                                     "reference")[4].counts)
        assert not ((counts == 2) | (counts == 3)).any()
    js = jax_create_train_state(
        JaxSegmentation(num_classes=c, feature_dim=f),
        optax.adam(jloop.make_lr_schedule(lr, 2)), jax.random.PRNGKey(0),
        jnp.zeros((b, m, 3)), jnp.zeros((b, m, 9)), init_kwargs={"train": False})

    def carried(js):
        state = create_train_state(c, f, loop.make_lr_schedule(lr, 2), device="cpu")
        return load_jax_train_state(state, jax.tree_util.tree_map(np.asarray, js))

    state = carried(js)
    step_j, eval_j = jloop.make_ndt_seg_step(m, c, False, "reference")
    step, eval_step = loop.make_ndt_seg_step(m, c, "reference")
    for _ in range(2):
        js, m_ref = step_j(js, *map(jnp.asarray, train))
        state, got = step(state, *map(torch.from_numpy, train))
        np.testing.assert_allclose(float(got["loss"]), float(m_ref["loss"]),
                                   rtol=5e-2)
    ref = float(eval_j(js, *map(jnp.asarray, val))["loss"])
    ours = float(eval_step(state, *map(torch.from_numpy, val))["loss"])
    print(f"eval loss after 2 steps at lr {lr}: JAX {ref:.6g}, port {ours:.6g}")
    assert ref > 1e6 and ours > 1e6
    assert abs(np.log10(ours / ref)) < 1
    np.testing.assert_allclose(
        float(eval_step(carried(js), *map(torch.from_numpy, val))["loss"]),
        ref, rtol=1e-5)


def test_streaming_step_equals_search_step():
    """Fixed voxel sizes taken from the search give the searching step's
    results bit for bit (train and eval), as tests/test_train.py holds
    the JAX steps."""
    from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state

    pts, labels = (torch.from_numpy(a) for a in clouds(8))
    step, eval_step = loop.make_ndt_seg_step(M, C, "fast")
    sizes = ndt_preprocessing_with_state(M, pts, None, C, search="fast")[4].voxel_size
    states = [create_train_state(C, F, loop.make_lr_schedule(LR, 2), device="cpu")
              for _ in range(2)]
    s_search, m_search = step(states[0], pts, labels)
    s_stream, m_stream = step(states[1], pts, labels, sizes)
    for k in ("loss", "accuracy"):
        assert torch.equal(m_search[k], m_stream[k])
    for a, b in zip(s_search.model.state_dict().values(),
                    s_stream.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(eval_step(s_search, pts, labels)["loss"],
                       eval_step(s_search, pts, labels, sizes)["loss"])


# ---- checkpoints, data, trainer ----

def test_checkpoint_resume_equals_training_straight_through(tmp_path):
    """save -> restore into a fresh state (other weights) -> continue is
    bitwise the run that never stopped: weights, BN buffers, Adam state,
    step, metrics."""
    pts, labels = (torch.from_numpy(a) for a in clouds(9))
    sched = loop.make_lr_schedule(LR, 1, decay_epochs=2)  # halves at step 2
    step, _ = loop.make_ndt_seg_step(M, C, "fast")
    straight = create_train_state(C, F, sched, device="cpu")
    for _ in range(3):
        straight, m_straight = step(straight, pts, labels)

    first = create_train_state(C, F, sched, device="cpu")
    for _ in range(2):
        first, _ = step(first, pts, labels)
    path = save_checkpoint(first, str(tmp_path / "ckpt"))
    resumed = restore_checkpoint(
        create_train_state(C, F, sched, seed=9, device="cpu"), path)
    assert resumed.step == 2
    resumed, m_resumed = step(resumed, pts, labels)
    assert resumed.step == straight.step == 3
    assert torch.equal(m_resumed["loss"], m_straight["loss"])
    for (ka, a), (kb, b) in zip(straight.model.state_dict().items(),
                                resumed.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
            assert v.device.type == "cpu"


def test_synthetic_seg_and_batches_match_the_jax_package():
    """The numpy copies draw the same clouds, labels and batch order."""
    ours, ref = SyntheticSeg(4, 300, length=5, seed=2), JaxSyntheticSeg(4, 300, length=5, seed=2)
    for i in range(5):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    ds = make_dataset(4, 300, synthetic_length=5, seed=2, int_labels=True)
    np.testing.assert_array_equal(ds[3][1], np.argmax(ref[3][1], -1))
    assert ds[3][1].dtype == np.int32
    got = list(batch_iterator(CachedDataset(ds), 2, shuffle=True, seed=4))
    want = list(jax_batch_iterator(ds, 2, shuffle=True, seed=4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    on_dev = list(prefetch_to_device(iter(got), "cpu"))
    assert len(on_dev) == 2 and torch.equal(on_dev[1][0], torch.from_numpy(got[1][0]))


@pytest.mark.parametrize("flag", [
    ["--use_pallas", "on"], ["--use_pallas", "off"],
])
def test_config_raises_on_flags_not_ported(flag):
    """The tensors' device picks the kernel route: ``--use_pallas`` takes
    only "auto" (the multi-host flags are ported: tests/test_torch_port_dp.py)."""
    with pytest.raises(NotImplementedError, match="device picks"):
        TrainConfig.from_args(["--device", "cpu"] + flag)


@pytest.mark.parametrize("flag,field,value", [
    (["--train_path", "x", "--val_path", "y", "--test_path", "z"],
     "train_path", "x"),
    (["--search", "grid"], "search", "grid"),
    (["--compute_dtype", "bfloat16"], "compute_dtype", "bfloat16"),
    (["--param_dtype", "bfloat16"], "param_dtype", "bfloat16"),
    (["--device_cache"], "device_cache", True),
])
def test_config_accepts_the_flags_of_the_rest_of_the_sampler_and_data(
        flag, field, value):
    """The segmentation trainers' PLY trees (CarlaSeg), the grid search
    and the trainer extras (bfloat16 types, the device-resident dataset)
    are ported: the config takes them as the JAX config does."""
    from ndtpu.train.config import TrainConfig as JaxTrainConfig

    cfg = TrainConfig.from_args(["--device", "cpu"] + flag)
    assert getattr(cfg, field) == value
    assert {k: v for k, v in vars(cfg).items() if k != "device"} == vars(
        JaxTrainConfig.from_args(flag))


def test_config_defaults_match_the_jax_trainer():
    """The segmentation and classification trainers' configs, and the
    multiscale and PointNet trainers' (their default overrides, still
    overridable on the command line), against the JAX package's."""
    from ndtpu.train.config import TrainConfig as JaxTrainConfig

    multiscale = dict(n_desired_nds=8160, batch_size=4, feature_dim=1024)
    pointnet = dict(n_samples=4160, save_every=10)  # tools/train_pointnet.py:27
    for argv, overrides in ((["--no-int_labels"], {}),
                            (["--task", "classification", "--train_path", "m",
                              "--val_path", "m"], {}),
                            ([], pointnet),
                            ([], multiscale)):
        ours = TrainConfig.from_args(["--device", "cpu"] + argv, **overrides)
        ref = JaxTrainConfig.from_args(argv, **overrides)
        assert {k: v for k, v in vars(ours).items() if k != "device"} == vars(ref)
        assert ours.device == "cpu"
    assert (ours.n_desired_nds, ours.n_desired_nds1, ours.batch_size) == (8160, 4080, 4)
    assert TrainConfig.from_args(["--device", "cpu", "--batch_size", "2"],
                                 **multiscale).batch_size == 2


def run_trainer(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ndtpu_torch.tools.train", "--device", "cpu",
         "--batch_size", "2", "--n_samples", "512", "--n_desired_nds", "32",
         "--n_classes", "4", "--feature_dim", "32", "--synthetic_length", "4",
         "--save_every", "1", "--out_path", str(tmp_path)] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    logs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return proc.stdout, logs


def test_trainer_cli_end_to_end_with_resume(tmp_path):
    """python -m ndtpu_torch.tools.train --device cpu: 2 steps a epoch,
    val and test evals, a checkpoint; --resume continues at step 2 (and
    --streaming trains with the searched sizes fixed)."""
    out, logs = run_trainer(["--epochs", "1"], tmp_path)
    assert [sorted(k for k in log if k.split("_")[0] in ("train", "val", "test"))
            for log in logs] == [
        ["train_last_accuracy", "train_last_loss", "train_mean_accuracy",
         "train_mean_loss"],
        ["val_last_accuracy", "val_last_loss", "val_mean_accuracy", "val_mean_loss"],
        ["test_last_accuracy", "test_last_loss", "test_mean_accuracy",
         "test_mean_loss"]]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    assert logs[0]["clouds_per_s"] > 0
    ckpt = out.split("saved checkpoint to ")[1].split()[0]
    out, logs = run_trainer(["--epochs", "1", "--resume", ckpt, "--streaming"],
                            tmp_path)
    assert f"resumed from {ckpt} at step 2" in out
    assert all(np.isfinite(v) for log in logs for v in log.values())
