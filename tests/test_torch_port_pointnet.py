"""The port's PointNet baseline and FPS against the JAX package: farthest
point sampling, both PointNet models in eval and train mode,
make_pointnet_seg_step over 3 steps, the gradients in float64, and the
train_pointnet CLI.

Inputs come from numpy seeds at a small size (B = 4 clouds of N = 1024
points, C = 4 classes, feature_dim 32); weights are carried over with
load_jax_variables / load_jax_train_state. Tolerances as for NDT-Net
(tests/test_torch_port_train.py): model outputs atol 1e-4 + rtol 1e-5,
running statistics rtol 1e-4 + atol 1e-5, the first step's loss rtol
1e-5 and later ones 5e-2 (Adam's update direction on f32-noise
gradients), float64 gradients to 1e-8 of each leaf's largest.

FPS picks by an argmax over f32 distances, so one rounding difference at
a near-tie changes every later pick. Its indices are compared exactly on
clouds whose distances are exact in f32 (integers times a power of two)
and, on random clouds, against JAX op by op (``jax.disable_jit``).
"""
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

from ndtpu.models import PointNetClassification as JaxClassification
from ndtpu.models import PointNetSegmentation as JaxSegmentation
from ndtpu.ops.fps import farthest_point_sampling as jax_fps
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.interop.jax_weights import _pairs, load_jax_train_state, load_jax_variables
from ndtpu_torch.models import PointNetClassification, PointNetSegmentation
from ndtpu_torch.ops.fps import farthest_point_sampling
from ndtpu_torch.train import loop
from ndtpu_torch.train.state import create_train_state
from test_torch_port_carla import ply_tree
from test_torch_port_models import perturbed
from test_torch_port_multiscale import calibrated
from test_torch_port_train import clouds, flat_grads

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, C, F = 4, 1024, 4, 32


def exact_cloud(n, seed):
    """[n, 3] f32 integers in [-64, 64) times 1/4: every squared distance
    and its sum over the axes is exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 64, size=(n, 3)) / 4.0).astype(np.float32)


# ---- FPS ----

@pytest.mark.parametrize("masked", [False, True])
def test_fps_matches_jax_on_exact_clouds(masked):
    """Two exact-arithmetic clouds (ties are common on the integer grid:
    both argmaxes take the first index) batched through the port against
    JAX's jitted FPS per cloud; a single [N, 3] cloud gives [n_samples]."""
    pts = np.stack([exact_cloud(3000, s) for s in (1, 2)])
    mask = np.random.default_rng(3).random((2, 3000)) > 0.4 if masked else None
    if masked:
        mask[:, 0] = True
    got = farthest_point_sampling(torch.from_numpy(pts), 300,
                                  None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 300) and got.dtype == torch.int64
    for b in range(2):
        ref = jax_fps(jnp.asarray(pts[b]), 300,
                      mask=None if mask is None else jnp.asarray(mask[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
        if masked:
            assert mask[b][got[b].numpy()].all()
    single = farthest_point_sampling(torch.from_numpy(pts[0]), 300,
                                     None if mask is None
                                     else torch.from_numpy(mask[0]))
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("masked", [False, True])
def test_fps_matches_jax_op_by_op_on_random_clouds(masked):
    """Random clouds against JAX's FPS under ``jax.disable_jit`` (each op
    rounded on its own, as torch does), with and without a mask."""
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(2, 2000, 3)) * 4).astype(np.float32)
    mask = rng.random((2, 2000)) > 0.3 if masked else None
    if masked:
        mask[:, 0] = True
    got = farthest_point_sampling(torch.from_numpy(pts), 200,
                                  None if mask is None else torch.from_numpy(mask))
    with jax.disable_jit():
        for b in range(2):
            ref = jax_fps(jnp.asarray(pts[b]), 200,
                          mask=None if mask is None else jnp.asarray(mask[b]))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_fps_spreads_points():
    """tests/test_data.py:76-89: two tight clusters 100 m apart; the first
    two picks come from both, and the port gives JAX's indices."""
    a = np.random.default_rng(0).normal(scale=0.01, size=(50, 3))
    pts = np.concatenate([a, a + np.array([100.0, 0, 0])]).astype(np.float32)
    idx = farthest_point_sampling(torch.from_numpy(pts), 4).numpy()
    assert len(set(idx.tolist())) == 4
    assert {int(i >= 50) for i in idx[:2]} == {0, 1}
    np.testing.assert_array_equal(idx, np.asarray(jax_fps(jnp.asarray(pts), 4)))


# ---- the models ----

def model_clouds():
    """[8, N, 3]: example_cloud of eight seeds (tests/test_torch_port_train.py
    uses four of them)."""
    return np.stack([example_cloud(1, N, seed=s)[0]
                     for s in (1, 5, 6, 7, 8, 9, 10, 21)])


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("task", ["segmentation", "classification"])
def test_pointnet_models_match_jax(task, mode):
    """Outputs (logits and the final softmax / log-softmax) at atol 1e-4 +
    rtol 1e-5 from the same weights, batch_stats moved off their initial
    0/1. In eval mode the statistics are first brought near the inputs'
    own (``calibrated``, tests/test_torch_port_multiscale.py), as a
    trained model's are: left near 0/1 they leave the layers unnormalised
    and the logits reach ~1e2, where f32 rounding alone exceeds the
    tolerance. In train mode also every running statistic after the
    forward (rtol 1e-4, atol 1e-5). Eight clouds: train-mode BatchNorm
    over the B rows of a TNet's FC layers is ill-conditioned for few rows
    (at B = 4 JAX's own f32 logits lie 3e-4 from a float64 evaluation, at
    B = 8 9e-5)."""
    pts = model_clouds()
    jax_model, port_model, shape, n_norms = {
        "segmentation": (JaxSegmentation, PointNetSegmentation,
                         (len(pts), N, C + 1), 2 * 5 + 3 + 3),
        "classification": (JaxClassification, PointNetClassification,
                           (len(pts), C), 2 * 5 + 3),
    }[task]
    jm = jax_model(num_classes=C, feature_dim=F)
    train = mode == "train"
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(pts))
    v = perturbed(v if train else calibrated(jm, v, (jnp.asarray(pts),)), 3)
    model = load_jax_variables(port_model(num_classes=C, feature_dim=F,
                                          device="cpu"), v)
    model.train(train)
    for logits in (True, False):
        ref, mut = jm.apply(v, jnp.asarray(pts), train=train,
                            return_logits=logits, mutable=["batch_stats"])
        before = [b.clone() for b in model.buffers()]
        with torch.no_grad():
            got = model(torch.from_numpy(pts), return_logits=logits)
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-5)
        if train:
            stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
            buffers = [(t, a) for t, a in _pairs(model, v["params"], stats)
                       if not isinstance(t, torch.nn.Parameter)]
            assert len(buffers) == 2 * n_norms
            for t, a in buffers:
                np.testing.assert_allclose(t.numpy(), a, rtol=1e-4, atol=1e-5)
            with torch.no_grad():  # the next forward starts from v again
                for b, old in zip(model.buffers(), before):
                    b.copy_(old)


def test_pointnet_input_transform_scrubs_non_finite_values():
    """nan_to_num after the input transform, as in the JAX backbone: a
    point at +-inf gives finite features in eval mode."""
    pts, _ = clouds(1)
    pts = pts.copy()
    pts[0, 5] = [np.inf, -np.inf, np.nan]
    jm = JaxSegmentation(num_classes=C, feature_dim=F)
    v = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(clouds(1)[0])), 3)
    model = load_jax_variables(PointNetSegmentation(
        num_classes=C, feature_dim=F, device="cpu"), v).eval()
    with torch.no_grad():
        transform = model.feature_extractor.t1(torch.from_numpy(pts))
        _, x_t2 = model.feature_extractor(torch.from_numpy(pts))
    assert not bool(torch.isfinite(transform).all())
    assert bool(torch.isfinite(x_t2).all())


# ---- steps ----

def jax_state(lr):
    model = JaxSegmentation(num_classes=C, feature_dim=F)
    return jax_create_train_state(
        model, optax.adam(jloop.make_lr_schedule(lr, steps_per_epoch=2)),
        jax.random.PRNGKey(0), jnp.zeros((B, N, 3)),
        init_kwargs={"train": False})


def port_state(js, lr):
    state = create_train_state(C, F, loop.make_lr_schedule(lr, 2),
                               device="cpu", model=PointNetSegmentation)
    return load_jax_train_state(state, jax.tree_util.tree_map(np.asarray, js))


def test_pointnet_step_matches_make_pointnet_seg_step_over_3_steps():
    """The port's step (int tags one-hot on the device) against JAX's
    jitted make_pointnet_seg_step from the same weights at lr 1e-3: the
    first loss within rtol 1e-5 and the accuracy within one point, the
    next two losses within rtol 5e-2; metrics are device scalars; the eval
    step on JAX's state carried over after the 3 steps at rtol 1e-5."""
    pts, labels = clouds(7)
    step_j, eval_j = jloop.make_pointnet_seg_step(C)
    js = jax_state(1e-3)
    state = port_state(js, 1e-3)
    step, eval_step = loop.make_pointnet_seg_step(C)
    tp, tl = torch.from_numpy(pts), torch.from_numpy(labels)
    for i in range(3):
        js, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
        state, m = step(state, tp, tl)
        assert m["loss"].dim() == 0 and m["loss"].device.type == "cpu"
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5 if i == 0 else 5e-2,
                                   err_msg=f"step {i}")
        if i == 0:
            assert abs(float(m["accuracy"]) - float(m_ref["accuracy"])) <= 1 / (B * N)
    assert state.step == int(js.step) == 3
    onehot = np.eye(C + 1, dtype=np.float32)[labels]
    for gt in (labels, onehot):  # int tags and one-hot give the same eval
        e_ref = eval_j(js, jnp.asarray(pts), jnp.asarray(gt))
        e = eval_step(port_state(js, 1e-3), tp, torch.from_numpy(gt))
        np.testing.assert_allclose(float(e["loss"]), float(e_ref["loss"]),
                                   rtol=1e-5)
        assert abs(float(e["accuracy"]) - float(e_ref["accuracy"])) <= 1 / (B * N)


def test_pointnet_gradients_match_jax_in_float64():
    """The float64 port model's gradients of the step's loss against JAX's
    loss_fn gradients in float64 (``jax.enable_x64``): every leaf that is
    not noise within 1e-8 of its largest; the f32 loss within rtol 1e-5."""
    pts, labels = clouds(5)
    onehot = np.eye(C + 1, dtype=np.float32)[labels]
    js = jax_state(1e-3)
    model = port_state(js, 1e-3).model
    loss = loop.cross_entropy_loss(
        model.train()(torch.from_numpy(pts), return_logits=True),
        torch.from_numpy(onehot))
    ref = js.apply_fn({"params": js.params, "batch_stats": js.batch_stats},
                      jnp.asarray(pts), train=True, return_logits=True,
                      mutable=["batch_stats"])[0]
    np.testing.assert_allclose(loss.item(), float(jloop.cross_entropy_loss(
        ref, jnp.asarray(onehot))), rtol=1e-5)

    twin = model.double()
    loss = loop.cross_entropy_loss(
        twin.train()(torch.from_numpy(pts).double(), return_logits=True),
        torch.from_numpy(onehot).double())
    loss.backward()
    with jax.enable_x64(True):
        model64 = JaxSegmentation(num_classes=C, feature_dim=F,
                                  dtype=jnp.float64, param_dtype=jnp.float64)
        to64 = functools.partial(jax.tree_util.tree_map,
                                 lambda a: jnp.asarray(np.asarray(a, np.float64)))
        stats64 = to64(js.batch_stats)

        def loss64(params):
            out, _ = model64.apply(
                {"params": params, "batch_stats": stats64},
                jnp.asarray(pts, jnp.float64), train=True, return_logits=True,
                mutable=["batch_stats"])
            return jloop.cross_entropy_loss(out, jnp.asarray(onehot, jnp.float64))

        grads64 = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss64))(to64(js.params)))
    leaves = [(name, p.grad.numpy(), g) for name, p, g in flat_grads(twin, grads64)]
    assert all(g.dtype == np.float64 for _, _, g in leaves)
    gmax = max(np.abs(g).max() for _, _, g in leaves)
    compared = 0
    for name, ours, g in leaves:
        if np.abs(g).max() >= 1e-6 * gmax:
            assert np.abs(ours - g).max() <= 1e-8 * np.abs(g).max(), name
            compared += 1
    assert compared > len(leaves) // 2


# ---- the trainer ----

def test_train_pointnet_cli_end_to_end_with_resume(tmp_path):
    """python -m ndtpu_torch.tools.train_pointnet --device cpu on CarlaSeg
    PLY trees: an epoch of 2 steps, val and test evals, a checkpoint named
    pointnet_segmentation_1; --resume continues at step 2."""
    paths = [ply_tree(tmp_path / split, n_files=4, n_points=700, n_classes=C,
                      seed=seed)
             for seed, split in enumerate(("train", "val", "test"))]
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(args):
        proc = subprocess.run(
            [sys.executable, "-m", "ndtpu_torch.tools.train_pointnet",
             "--device", "cpu", "--epochs", "1", "--batch_size", "2",
             "--n_samples", "512", "--n_classes", str(C), "--feature_dim",
             "16", "--save_every", "1", "--out_path", str(tmp_path / "out"),
             "--train_path", paths[0], "--val_path", paths[1],
             "--test_path", paths[2]] + args,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout, [json.loads(line) for line in proc.stdout.splitlines()
                             if line.startswith("{")]

    out, logs = run([])
    assert [sorted(k for k in log if k.endswith("mean_loss")) for log in logs] == [
        ["train_mean_loss"], ["val_mean_loss"], ["test_mean_loss"]]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    ckpt = out.split("saved checkpoint to ")[1].split()[0]
    assert ckpt.endswith("pointnet_segmentation_1")
    out, logs = run(["--resume", ckpt])
    assert f"resumed from {ckpt} at step 2" in out
    assert all(np.isfinite(v) for log in logs for v in log.values())


def test_new_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The models, trainer, sampler and dataset added with the PointNet
    baseline and the CARLA path default to the card and raise where there
    is none."""
    from ndtpu_torch.core.ndt import NDTSampler
    from ndtpu_torch.data.carla import CarlaNDTSeg
    from ndtpu_torch.tools import train_pointnet

    path = ply_tree(tmp_path / "t", n_files=1, n_points=100, n_classes=C)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PointNetSegmentation(num_classes=C, feature_dim=F),
                 lambda: PointNetClassification(num_classes=C, feature_dim=F),
                 lambda: train_pointnet.main(["--epochs", "1"]),
                 lambda: NDTSampler(np.zeros((10, 3))),
                 lambda: CarlaNDTSeg(C, 64, 16, path)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
