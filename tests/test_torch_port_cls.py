"""The port's classification slice on the CPU against the JAX package: the
shape and ModelNet data, NDTNetClassification in eval and train mode, the
classification step over 3 steps, its gradients in float64, and the
trainer CLI's classification task.

Inputs come from numpy seeds at a small size (B = 4, N = 1024, M = 16,
C = 4 classes, feature_dim 32); the clouds are the train tests' four
distinct ``example_cloud`` clouds without a 2- or 3-point voxel at M = 16
(see tests/test_torch_port_train.py for why four and why no such voxel).
The JAX side takes its XLA route (``use_pallas=False``), as its own CPU
tests do; whole steps use the reference search on both sides.
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

from ndtpu.data import classification as jax_cls
from ndtpu.data import ply as jax_ply
from ndtpu.data import synthetic as jax_syn
from ndtpu.models import NDTNetClassification as JaxClassification
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch.data import classification, ply, synthetic
from ndtpu_torch.interop.jax_weights import _pairs, load_jax_train_state, load_jax_variables
from ndtpu_torch.models import NDTNetClassification
from ndtpu_torch.tools.train import make_cls_dataset
from ndtpu_torch.train import loop
from ndtpu_torch.train.config import TrainConfig
from ndtpu_torch.train.state import create_train_state

from test_torch_port_models import perturbed
from test_torch_port_train import clouds, flat_grads, prep_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, M, C, F = 4, 1024, 16, 4, 32
LABELS = np.eye(C, dtype=np.float32)[[0, 1, 2, 3]]  # one cloud a class


def jax_state(lr):
    model = JaxClassification(num_classes=C, feature_dim=F)
    return jax_create_train_state(
        model, optax.adam(jloop.make_lr_schedule(lr, steps_per_epoch=2)),
        jax.random.PRNGKey(0), jnp.zeros((B, M, 3)), jnp.zeros((B, M, 9)),
        init_kwargs={"train": False})


def port_state(js, lr):
    state = create_train_state(C, F, loop.make_lr_schedule(lr, 2),
                               device="cpu", model=NDTNetClassification)
    return load_jax_train_state(state, jax.tree_util.tree_map(np.asarray, js))


# ---- data ----

def test_synthetic_cls_and_random_cloud_are_bitwise_the_jax_package():
    """Every shape class (two lengths of cloud, two seeds) and the stress
    cloud: the same numpy draws give the same bits."""
    for seed, n in ((0, 300), (3, 1000)):
        ours, ref = synthetic.SyntheticCls(n, length=16, seed=seed), \
            jax_syn.SyntheticCls(n, length=16, seed=seed)
        assert len(ours) == len(ref) and ours.n_classes == ref.n_classes == 8
        for i in range(16):
            (p, label), (q, want) = ours[i], ref[i]
            assert label == want == i % 8
            assert p.dtype == np.float32 and p.tobytes() == q.tobytes(), i
    for kw in ({}, {"n_points": 500, "extent": 3.0, "seed": 7}):
        np.testing.assert_array_equal(synthetic.random_cloud(**kw),
                                      jax_syn.random_cloud(**kw))
    with pytest.raises(IndexError):
        synthetic.SyntheticCls(10, length=2)[2]


def write_off(path, verts, glued):
    """An OFF mesh of ``verts`` with one face; the counts glued onto the
    header line (ModelNet's ``OFF123 456 0``) or on their own line."""
    head = (f"OFF{len(verts)} 1 0\n" if glued else f"OFF\n{len(verts)} 1 0\n")
    body = "".join(f"{x:.8g} {y:.8g} {z:.8g}\n" for x, y, z in verts)
    path.write_text(head + body + "3 0 1 2\n")


def write_ply(path, verts, classes=None):
    props = ["property double x", "property double y", "property double z"]
    rows = verts
    if classes is not None:
        props.append("property ushort class")
        rows = np.concatenate([verts, classes[:, None]], 1)
    head = "\n".join(["ply", "format ascii 1.0", f"element vertex {len(verts)}",
                      *props, "end_header", ""])
    path.write_text(head + "".join(" ".join(f"{v:.8g}" for v in r) + "\n"
                                   for r in rows))


def test_read_off_and_read_ply_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(37, 3)) * 5
    for glued in (True, False):
        write_off(tmp_path / f"m{glued}.off", verts, glued)
        got = classification.read_off(str(tmp_path / f"m{glued}.off"))
        np.testing.assert_array_equal(
            got, jax_cls.read_off(str(tmp_path / f"m{glued}.off")))
        assert got.shape == (37, 3)
    (tmp_path / "bad.off").write_text("COFF\n1 0 0\n0 0 0\n")
    with pytest.raises(ValueError):
        classification.read_off(str(tmp_path / "bad.off"))
    for classes in (None, rng.integers(0, 9, 37)):
        p = tmp_path / "c.ply"
        write_ply(p, verts, classes)
        got = ply.read_ply(str(p))
        for ref in (jax_ply.read_ply(str(p)),
                    jax_ply.read_ply(str(p), use_native=False)):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    (tmp_path / "bad.ply").write_text("ply\nformat ascii 1.0\n")
    with pytest.raises(ValueError, match="unterminated"):
        ply.read_ply(str(tmp_path / "bad.ply"))


def modelnet_tree(root, val_dir=False):
    """Three classes with 12 train meshes (OFF in both header forms and
    PLY, some smaller than n_points so they are drawn with replacement) and
    3 test meshes each; a val/ directory too if asked."""
    rng = np.random.default_rng(2)
    for c, name in enumerate(("chair", "desk", "lamp")):
        for split, count in (("train", 12), ("test", 3)) + (
                (("val", 2),) if val_dir else ()):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(count):
                verts = rng.normal(size=(20 + 7 * i, 3)) * (c + 1) + c
                if i % 3 == 2:
                    write_ply(d / f"{name}_{i:04d}.ply", verts)
                else:
                    write_off(d / f"{name}_{i:04d}.off", verts, glued=i % 3 == 0)
            (d / "notes.txt").write_text("not a mesh")
    return root


@pytest.mark.parametrize("split,val_dir", [
    ("train", False), ("test", False), ("val", False), ("train+holdout", False),
    ("val", True),
])
def test_modelnet_cls_matches_the_jax_package(tmp_path, split, val_dir):
    """The same items (paths, labels) and, fetched in the same order,
    the same centred unit-sphere points; the carved val is every 10th train
    file of a class and train+holdout the rest."""
    root = str(modelnet_tree(tmp_path, val_dir))
    ours = classification.ModelNetCls(root, split, n_points=64, seed=3)
    ref = jax_cls.ModelNetCls(root, split, n_points=64, seed=3)
    assert ours.items == ref.items and ours.n_classes == ref.n_classes == 3
    if split == "val" and not val_dir:
        assert [os.path.basename(p) for p, _ in ours.items] == [
            f"{c}_{i:04d}.{'ply' if i % 3 == 2 else 'off'}"
            for c in ("chair", "desk", "lamp") for i in (0, 10)]
    if split == "train+holdout":
        carved = classification.ModelNetCls(root, "val", n_points=64)
        assert len(ours) + len(carved) == 36
        assert not set(ours.items) & set(carved.items)
    order = list(range(len(ours))) + [1, 0, len(ours) - 1]
    for i in order:
        (p, label), (q, want) = ours[i], ref[i]
        assert label == want
        np.testing.assert_array_equal(p, q)
        assert p.shape == (64, 3) and p.dtype == np.float32
        assert np.linalg.norm(p, axis=1).max() <= 1 + 1e-6


def test_make_cls_dataset_carves_val_and_checks_classes(tmp_path):
    root = str(modelnet_tree(tmp_path))
    cfg = TrainConfig.from_args(["--device", "cpu", "--task", "classification",
                                 "--train_path", root, "--val_path", root,
                                 "--test_path", root, "--n_classes", "3",
                                 "--n_samples", "32"])
    train = make_cls_dataset(cfg, "train", 0)
    val = make_cls_dataset(cfg, "val", 1)
    assert train.ds.split == "train+holdout" and val.ds.split == "val"
    assert len(train) == 30 and len(val) == 6
    pts, onehot = val[5]
    assert pts.shape == (32, 3) and onehot.tolist() == [0.0, 0.0, 1.0]
    cfg.n_classes = 2
    with pytest.raises(ValueError, match="3 classes"):
        make_cls_dataset(cfg, "test", 2)
    synth = make_cls_dataset(TrainConfig(task="classification", n_classes=10,
                                         n_samples=40, synthetic_length=3),
                             "val", 1)
    assert len(synth) == 3 and synth[2][1].shape == (10,)


# ---- the model ----

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_classification_model_matches_jax(mode):
    """Logits and probabilities at atol 1e-4 + rtol 1e-5; in train mode
    also every running statistic after the forward (rtol 1e-4, atol
    1e-5). batch_stats start off their initial 0/1."""
    pcl, covs, _, _ = prep_numpy(*clouds(1))
    jm = JaxClassification(num_classes=C, feature_dim=F)
    v = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(pcl),
                          jnp.asarray(covs)), 3)
    model = load_jax_variables(NDTNetClassification(
        num_classes=C, feature_dim=F, device="cpu"), v)
    train = mode == "train"
    model.train(train)
    for logits in (True, False):
        ref, mut = jm.apply(v, jnp.asarray(pcl), jnp.asarray(covs),
                            train=train, return_logits=logits,
                            mutable=["batch_stats"])
        before = [b.clone() for b in model.buffers()]
        with torch.no_grad():
            got = model(torch.from_numpy(pcl), torch.from_numpy(covs),
                        return_logits=logits)
        assert got.shape == (B, C)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-5)
        if train:
            stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
            buffers = [(t, a) for t, a in _pairs(model, v["params"], stats)
                       if not isinstance(t, torch.nn.Parameter)]
            assert len(buffers) == 2 * 13  # 2 TNets of 5 norms, 3 of its own
            for t, a in buffers:
                np.testing.assert_allclose(t.numpy(), a, rtol=1e-4, atol=1e-5)
            with torch.no_grad():  # the next forward starts from v again
                for b, old in zip(model.buffers(), before):
                    b.copy_(old)
    if not train:
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---- steps ----

def test_classification_step_matches_make_classification_step_over_3_steps():
    """The port's step (its own untagged preprocessing) against JAX's
    jitted make_classification_step from the same weights, at lr 1e-3:
    the first loss within rtol 1e-5 and the accuracy exact, the next two
    losses within rtol 5e-2 (Adam's update direction on f32-noise
    gradients, tests/test_torch_port_train.py). The eval step is compared
    on JAX's state after the 3 steps, carried over, at rtol 1e-5: after
    its own steps the port's eval loss lies as far from its float64
    twin's as from JAX's (up to ~25 % on these clouds), because in eval
    mode the biases in front of each BatchNorm, moved +-lr by noise, shift
    the activations."""
    pts, _ = clouds(7)
    prep_numpy(pts, np.zeros(pts.shape[:2], np.int32))
    step_j, eval_j = jloop.make_classification_step(M, C, False, "reference")
    js = jax_state(1e-3)
    state = port_state(js, 1e-3)
    step, eval_step = loop.make_classification_step(M, C, "reference")
    tp, tl = torch.from_numpy(pts), torch.from_numpy(LABELS)
    for i in range(3):
        js, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(LABELS))
        state, m = step(state, tp, tl)
        assert m["loss"].dim() == 0 and m["loss"].device.type == "cpu"
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5 if i == 0 else 5e-2,
                                   err_msg=f"step {i}")
        if i == 0:
            assert float(m["accuracy"]) == float(m_ref["accuracy"])
    assert state.step == int(js.step) == 3
    e_ref = eval_j(js, jnp.asarray(pts), jnp.asarray(LABELS))
    e = eval_step(port_state(js, 1e-3), tp, tl)
    np.testing.assert_allclose(float(e["loss"]), float(e_ref["loss"]), rtol=1e-5)
    assert float(e["accuracy"]) == float(e_ref["accuracy"])


def test_classification_gradients_match_jax_in_float64():
    """On the same preprocessed batch, the float64 port model's gradients
    of the step's loss against JAX's loss_fn gradients in float64
    (``jax.enable_x64``): every leaf that is not noise within 1e-8 of its
    largest; the f32 loss within rtol 1e-5 of JAX's."""
    pcl, covs, _, _ = prep_numpy(*clouds(5))
    js = jax_state(1e-3)
    model = port_state(js, 1e-3).model
    logits = model.train()(torch.from_numpy(pcl), torch.from_numpy(covs),
                           return_logits=True)
    loss = loop.cross_entropy_loss(logits, torch.from_numpy(LABELS))
    ref = js.apply_fn({"params": js.params, "batch_stats": js.batch_stats},
                      jnp.asarray(pcl), jnp.asarray(covs), train=True,
                      return_logits=True, mutable=["batch_stats"])[0]
    np.testing.assert_allclose(loss.item(), float(jloop.cross_entropy_loss(
        ref, jnp.asarray(LABELS))), rtol=1e-5)

    twin = model.double()
    loss = loop.cross_entropy_loss(
        twin.train()(torch.from_numpy(pcl).double(),
                     torch.from_numpy(covs).double(), return_logits=True),
        torch.from_numpy(LABELS).double())
    loss.backward()
    with jax.enable_x64(True):
        model64 = JaxClassification(num_classes=C, feature_dim=F,
                                    dtype=jnp.float64, param_dtype=jnp.float64)
        to64 = functools.partial(jax.tree_util.tree_map,
                                 lambda a: jnp.asarray(np.asarray(a, np.float64)))
        stats64 = to64(js.batch_stats)

        def loss64(params):
            out, _ = model64.apply(
                {"params": params, "batch_stats": stats64},
                jnp.asarray(pcl, jnp.float64), jnp.asarray(covs, jnp.float64),
                train=True, return_logits=True, mutable=["batch_stats"])
            return jloop.cross_entropy_loss(out, jnp.asarray(LABELS, jnp.float64))

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

def run_trainer(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ndtpu_torch.tools.train", "--device", "cpu",
         "--task", "classification", "--batch_size", "4", "--n_samples", "512",
         "--n_desired_nds", "32", "--n_classes", "8", "--feature_dim", "32",
         "--save_every", "1", "--out_path", str(tmp_path)] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    return proc


def test_classification_trainer_cli_end_to_end_with_resume(tmp_path):
    """python -m ndtpu_torch.tools.train --task classification --device
    cpu: on SyntheticCls an epoch of 2 steps, val and test evals and a
    checkpoint ndtnet_classification_1; --resume continues at step 2; on a
    ModelNet tree with the val carved out of train; --streaming refused."""
    proc = run_trainer(["--epochs", "1", "--synthetic_length", "8"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    logs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [sorted(k for k in log if "loss" in k) for log in logs] == [
        ["train_last_loss", "train_mean_loss"], ["val_last_loss", "val_mean_loss"],
        ["test_last_loss", "test_mean_loss"]]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    ckpt = proc.stdout.split("saved checkpoint to ")[1].split()[0]
    assert os.path.basename(ckpt) == "ndtnet_classification_1"
    proc = run_trainer(["--epochs", "1", "--synthetic_length", "8",
                        "--resume", ckpt], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"resumed from {ckpt} at step 2" in proc.stdout

    root = str(modelnet_tree(tmp_path / "modelnet"))
    proc = run_trainer(["--epochs", "1", "--train_path", root, "--val_path",
                        root, "--test_path", root, "--batch_size", "8"],
                       tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ndtnet_classification_1" in proc.stdout  # 30 train clouds: 3 steps

    proc = run_trainer(["--epochs", "1", "--streaming"], tmp_path)
    assert proc.returncode != 0
    assert "--streaming supports the segmentation task only" in proc.stderr
