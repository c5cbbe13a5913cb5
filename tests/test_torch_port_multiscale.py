"""The port's NDT-Net++ family on the CPU against the JAX package:
ResidualConnection, NDTNetPP, NDTNetPPClassification and
NDTNetPPSegmentation in eval and train mode on the same JAX fine state,
the multiscale train step over 3 steps, and the multiscale trainer CLI.

Inputs come from numpy seeds at a small size (B = 8 distinct
``example_cloud`` clouds of N = 1024 points, fine 16 and coarse 8 NDs,
C = 4 classes, feature_dim 32). Eight clouds, not four: the train-mode
BatchNorm over the B rows of the TNets' FC layers runs in both branches
and in the shared ndtnet2 twice, and at B = 4 the f32 outputs of either
framework lie up to 1e-4 of their scale from float64 (the port's no
farther than JAX's), at B = 8 within 2e-5. The JAX preprocessing takes its XLA route
with the reference search, tagged with int labels as the multiscale step
tags both resolutions; no cloud has a 2- or 3-point voxel at either
resolution (tests/test_torch_port_train.py says why). The models take
the JAX fine state as it is (converted field by field), so both sides
prune the same state.
"""
import dataclasses
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

from ndtpu.models import NDTNetPP as JaxPP
from ndtpu.models import NDTNetPPClassification as JaxPPCls
from ndtpu.models import NDTNetPPSegmentation as JaxPPSeg
from ndtpu.models import ResidualConnection as JaxResidual
from ndtpu.preprocessing.batch import ndt_preprocessing_with_state as jax_prep
from ndtpu.train import loop as jloop
from ndtpu.train.state import create_train_state as jax_create_train_state
from ndtpu_torch.core import ndt as tn
from ndtpu_torch.data.synthetic import example_cloud
from ndtpu_torch.interop.jax_weights import _pairs, load_jax_train_state, load_jax_variables
from ndtpu_torch.models import (
    NDTNetPP,
    NDTNetPPClassification,
    NDTNetPPSegmentation,
    ResidualConnection,
)
from ndtpu_torch.tools import train_multiscale
from ndtpu_torch.train import loop
from ndtpu_torch.train.state import create_train_state

from test_torch_port_models import perturbed

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N, FINE, COARSE, C, F = 8, 1024, 16, 8, 4, 32
SEEDS = {1: (1, 3, 5, 6, 7, 8, 9, 10), 2: (16, 21, 22, 29, 30, 33, 35, 1),
         3: (3, 5, 7, 9, 10, 22, 30, 35)}


def ms_clouds(key):
    """[B, N, 3] clouds of the seeds SEEDS[key] and int labels [B, N] in
    1..4 by the signs of x and y."""
    pts = np.stack([example_cloud(1, N, seed=s)[0] for s in SEEDS[key]])
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    return pts, labels


def jax_inputs(key):
    """The JAX fine and coarse preprocessing (reference search, tagged):
    (p1, c1, state1, p2, c2) as JAX arrays and a batched NDTResult."""
    pts, labels = ms_clouds(key)
    p1, c1, _, _, st1 = jax_prep(FINE, jnp.asarray(pts), jnp.asarray(labels),
                                 C, False, "reference")
    p2, c2, _, _, st2 = jax_prep(COARSE, jnp.asarray(pts), jnp.asarray(labels),
                                 C, False, "reference")
    for st in (st1, st2):
        counts = np.asarray(st.counts)
        assert not ((counts == 2) | (counts == 3)).any()
    return p1, c1, st1, p2, c2


def port_inputs(args):
    """The same inputs as the port takes them: tensors and the port's
    batched NDTResult."""
    p1, c1, st1, p2, c2 = args
    state = tn.NDTResult(**{
        f.name: torch.from_numpy(np.array(getattr(st1, f.name)))
        for f in dataclasses.fields(tn.NDTResult)
    })
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return t(p1), t(c1), state, t(p2), t(c2)


def make_models(name):
    """(JAX module, port module on the CPU) of a model name."""
    if name == "residual":
        return (JaxResidual(FINE, COARSE), ResidualConnection(FINE, COARSE))
    if name == "ndtnetpp":
        return (JaxPP(fine_res=FINE, coarse_res=COARSE, feature_dim=F),
                NDTNetPP(fine_res=FINE, coarse_res=COARSE, feature_dim=F))
    cls = {"classification": (JaxPPCls, NDTNetPPClassification),
           "segmentation": (JaxPPSeg, NDTNetPPSegmentation)}[name]
    return (cls[0](num_classes=C, fine_res=FINE, coarse_res=COARSE,
                   feature_dim=F),
            cls[1](num_classes=C, fine_res=FINE, coarse_res=COARSE,
                   feature_dim=F, device="cpu"))


def calibrated(jm, v, args, forwards=10):
    """The flax variables v with the batch_stats of ``forwards`` JAX
    train-mode forwards on args, each starting from the last one's."""
    stats = jax.jit(lambda v: jm.apply(v, *args, train=True,
                                       mutable=["batch_stats"])[1]["batch_stats"])
    for _ in range(forwards):
        v = {"params": v["params"], "batch_stats": stats(v)}
    return v


def ndtnet2_calls(model):
    """A counter of the forwards of the model's shared ndtnet2."""
    pp = {NDTNetPP: lambda m: m, NDTNetPPClassification: lambda m:
          m.feature_extractor, NDTNetPPSegmentation: lambda m: m.ndnet}
    calls = []
    if type(model) in pp:
        pp[type(model)](model).ndtnet2.register_forward_hook(
            lambda *_: calls.append(1))
    return calls


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", ["residual", "ndtnetpp", "classification",
                                  "segmentation"])
def test_multiscale_models_match_jax(name, mode):
    """Every output (NDTNetPP's (feat, feat1); the heads' logits and their
    softmax probabilities) within atol 1e-4 + rtol 1e-5 of JAX's, entry by
    entry, from the same weights with batch_stats moved off 0/1. In eval
    mode the statistics are first brought near the inputs' own
    (``calibrated``), as a trained model's are: left at 0/1 they leave
    every layer unnormalised and the outputs reach ~1e5, where both
    frameworks' f32 rounding alone exceeds the tolerance. In train mode
    also every running statistic after the forward (rtol 1e-4, atol
    1e-5), among them the shared ndtnet2's after both of its calls,
    branch 1 then branch 2."""
    args = jax_inputs(1)
    jm, model = make_models(name)
    if name == "residual":
        x = np.random.default_rng(4).normal(size=(B, FINE, F)).astype(np.float32)
        args, targs = (jnp.asarray(x),), (torch.from_numpy(x),)
    else:
        targs = port_inputs(args)
    train = mode == "train"
    v = jm.init(jax.random.PRNGKey(5), *args)
    v = perturbed(v if train else calibrated(jm, v, args), 6)
    load_jax_variables(model, v)
    model.train(train)
    calls = ndtnet2_calls(model)
    heads = [{}] if name in ("residual", "ndtnetpp") else [
        {"return_logits": True}, {"return_logits": False}]
    start = {k: b.clone() for k, b in model.named_buffers()}
    for kw in heads:
        ref, mut = jm.apply(v, *args, train=train, mutable=["batch_stats"], **kw)
        with torch.no_grad():
            got = model(*targs, **kw)
        refs = ref if isinstance(ref, tuple) else (ref,)
        gots = got if isinstance(got, tuple) else (got,)
        for g, r in zip(gots, refs):
            assert g.shape == r.shape
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=1e-5)
        if kw.get("return_logits") is False:
            np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
        if train:
            stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
            buffers = [(t, a) for t, a in _pairs(model, v["params"], stats)
                       if not isinstance(t, torch.nn.Parameter)]
            assert len(buffers) == 2 * len([m for m in model.modules()
                                            if hasattr(m, "running_mean")])
            for t, a in buffers:
                np.testing.assert_allclose(t.numpy(), a, rtol=1e-4, atol=1e-5)
            with torch.no_grad():  # the next forward starts from v again
                for k, b in model.named_buffers():
                    b.copy_(start[k])
    assert len(calls) == (0 if name == "residual" else 2 * len(heads))


def jax_state(lr, args):
    model = JaxPPSeg(num_classes=C, fine_res=FINE, coarse_res=COARSE,
                     feature_dim=F)
    return jax_create_train_state(
        model, optax.adam(jloop.make_lr_schedule(lr, steps_per_epoch=2)),
        jax.random.PRNGKey(0), *args, init_kwargs={"train": False})


def port_state(js, lr):
    state = create_train_state(C, F, loop.make_lr_schedule(lr, 2),
                               device="cpu", model=NDTNetPPSegmentation,
                               fine_res=FINE, coarse_res=COARSE)
    return load_jax_train_state(state, jax.tree_util.tree_map(np.asarray, js))


@pytest.mark.parametrize("key", [2, 3])
def test_multiscale_step_matches_make_multiscale_seg_step_over_3_steps(key):
    """The port's step (its own fine and coarse preprocessing, int labels)
    against JAX's jitted make_multiscale_seg_step from the same weights, at
    lr 1e-3: the first loss within rtol 1e-5 and the accuracy within one
    ND, the next two losses within rtol 5e-2 (Adam's direction on
    f32-noise gradients, tests/test_torch_port_train.py); the eval step on
    JAX's state after the 3 steps, carried over, at rtol 1e-5
    (tests/test_torch_port_cls.py says why not on the port's own)."""
    args = jax_inputs(key)  # asserts the clouds hold no 2/3-point voxel
    pts, labels = ms_clouds(key)
    step_j, eval_j = jloop.make_multiscale_seg_step(FINE, COARSE, C, False,
                                                    "reference")
    js = jax_state(1e-3, args)
    state = port_state(js, 1e-3)
    step, eval_step = loop.make_multiscale_seg_step(FINE, COARSE, C, "reference")
    tp, tl = torch.from_numpy(pts), torch.from_numpy(labels)
    for i in range(3):
        js, m_ref = step_j(js, jnp.asarray(pts), jnp.asarray(labels))
        state, m = step(state, tp, tl)
        assert m["loss"].dim() == 0 and m["loss"].device.type == "cpu"
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5 if i == 0 else 5e-2,
                                   err_msg=f"step {i}")
        if i == 0:
            assert abs(float(m["accuracy"]) - float(m_ref["accuracy"])) <= 1 / (B * FINE)
    assert state.step == int(js.step) == 3
    e_ref = eval_j(js, jnp.asarray(pts), jnp.asarray(labels))
    e = eval_step(port_state(js, 1e-3), tp, tl)
    np.testing.assert_allclose(float(e["loss"]), float(e_ref["loss"]), rtol=1e-5)
    assert abs(float(e["accuracy"]) - float(e_ref["accuracy"])) <= 1 / (B * FINE)


def run_trainer(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "ndtpu_torch.tools.train_multiscale",
         "--device", "cpu", "--batch_size", "2", "--n_samples", "512",
         "--n_desired_nds", "32", "--n_desired_nds1", "16", "--n_classes", "4",
         "--feature_dim", "32", "--synthetic_length", "4", "--save_every", "1",
         "--out_path", str(tmp_path)] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_multiscale_trainer_cli_end_to_end_with_resume(tmp_path):
    """python -m ndtpu_torch.tools.train_multiscale --device cpu: an epoch
    of 2 steps and a val eval (no test split), a checkpoint
    ndtnetpp_segmentation_1; --resume continues at step 2;
    --task classification and --streaming are refused."""
    proc = run_trainer(["--epochs", "1"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    logs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [sorted(k for k in log if "loss" in k) for log in logs] == [
        ["train_last_loss", "train_mean_loss"], ["val_last_loss", "val_mean_loss"]]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    ckpt = proc.stdout.split("saved checkpoint to ")[1].split()[0]
    assert os.path.basename(ckpt) == "ndtnetpp_segmentation_1"
    proc = run_trainer(["--epochs", "1", "--resume", ckpt], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"resumed from {ckpt} at step 2" in proc.stdout
    for flag, why in ((["--task", "classification"], "segmentation task only"),
                      (["--streaming"], "searches both voxel sizes")):
        proc = run_trainer(["--epochs", "1"] + flag, tmp_path)
        assert proc.returncode != 0 and why in proc.stderr


def test_new_entry_points_raise_without_a_card(monkeypatch):
    """The models and trainers of this slice default to the card and
    raise where there is none."""
    from ndtpu_torch.models import NDTNetClassification
    from ndtpu_torch.tools.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: NDTNetClassification(num_classes=4, feature_dim=32),
                 lambda: NDTNetPPClassification(num_classes=4, feature_dim=32),
                 lambda: NDTNetPPSegmentation(num_classes=4, feature_dim=32),
                 lambda: train_main(["--task", "classification", "--epochs", "1"]),
                 lambda: train_multiscale.main(["--epochs", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
