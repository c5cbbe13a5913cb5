"""The port's parity experiment (``python -m ndtpu_torch.tools.
parity_train``) against the JAX tool's, on a stand-in reference module.

The reference's model code is not in the repository, so
``load_reference_module`` is patched on both sides to give a stand-in
module built here: ``NDTNetSegmentation`` and ``NDTNetClassification`` in
the reference layout (Conv1d(k=1) pointwise layers, Linear fc1..3,
BatchNorm1d) with a forward of the NDT-Net arithmetic on them. On it:

- build_dataset equal to JAX's, preprocess equal to JAX's run op by op
  (``jax.disable_jit``; under ``jit`` XLA's FMAs can flip a 2- or 3-point
  voxel's KL, ROADMAP.md faults);
- train_torch (the reference side) equal to JAX's train_torch;
- one epoch of the port side against JAX's train_ndtpu from the same
  transplanted init in float64: the loss curve within 1e-5 relative;
- main end to end, and the FileNotFoundError without the reference.
"""
import json
import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ndtpu.interop import reference_loader as jax_reference_loader
from ndtpu_torch.models import NDTNetClassification, NDTNetSegmentation
from ndtpu_torch.tools import parity_train

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX tool is a script: tools/ for its `import _common`
for _p in (str(ROOT / "tools"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import tools.parity_train as jax_parity  # noqa: E402

# the reference-layout stand-in of a port model, beside this file
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_port_interop import mirror  # noqa: E402


def lin(layer, x):
    """A reference Conv1d(k=1) or Linear on channels-last x."""
    w = layer.weight
    return F.linear(x, w[..., 0] if w.dim() == 3 else w, layer.bias)


def norm(layer, x):
    """A BatchNorm1d over the channels of channels-last x."""
    return layer(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def ref_tnet(t, x):
    h = torch.relu(norm(t.bn1, lin(t.conv1, x)))
    h = torch.relu(norm(t.bn2, lin(t.conv2, h)))
    h = torch.relu(norm(t.bn3, lin(t.conv3, h))).amax(1)
    h = torch.relu(t.bn4(lin(t.fc1, h)))
    h = torch.relu(t.bn5(lin(t.fc2, h)))
    d = int(round(t.fc3.weight.shape[0] ** 0.5))
    eye = torch.eye(d, dtype=h.dtype).reshape(-1)
    return (lin(t.fc3, h) + eye).reshape(-1, d, d)


def ref_backbone(m, points, covs):
    b, n, _ = points.shape
    t = ref_tnet(m.t1, points)
    x = torch.cat([torch.einsum("bij,bnj->bni", t, points),
                   torch.einsum("bij,bnjk->bnik", t,
                                covs.reshape(b, n, 3, 3)).reshape(b, n, 9)],
                  -1)
    x = norm(m.bn1, lin(m.conv1, x))
    x = torch.einsum("bnj,bji->bni", x, ref_tnet(m.t2, x))
    x_t2 = x
    x = norm(m.bn2, lin(m.conv2, x))
    return norm(m.bn3, lin(m.conv3, x)), x_t2


class RefSegmentation(nn.Module):
    """A stand-in for the reference's NDTNetSegmentation(point_dim,
    num_classes, feature_dim): its layout (``mirror`` of the port model)
    and a forward on [B, N, 3] points and [B, N, 9] covariances giving
    [B, N, C + 1] log-probabilities."""

    def __init__(self, point_dim, num_classes, feature_dim):
        super().__init__()
        layout = mirror(NDTNetSegmentation(point_dim, num_classes, feature_dim,
                                           device="cpu"))
        for name, child in layout.named_children():
            setattr(self, name, child)

    def forward(self, points, covs):
        x, x_t2 = ref_backbone(self.feature_extractor, points, covs)
        x = torch.cat([x_t2, x.amax(1, keepdim=True).expand_as(x)], -1)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = torch.relu(norm(bn, lin(conv, x)))
        return torch.log_softmax(lin(self.conv4, x), -1)


class RefClassification(nn.Module):
    """The stand-in of the reference's NDTNetClassification: [B, C, 1]
    probabilities."""

    def __init__(self, point_dim, num_classes, feature_dim):
        super().__init__()
        layout = mirror(NDTNetClassification(point_dim, num_classes,
                                             feature_dim, device="cpu"))
        for name, child in layout.named_children():
            setattr(self, name, child)

    def forward(self, points, covs):
        x, _ = ref_backbone(self.feature_extractor, points, covs)
        x = torch.relu(lin(self.conv1, x.amax(1)))
        x = torch.relu(lin(self.conv2, x))
        return torch.softmax(lin(self.conv3, x), -1)[:, :, None]


REF = types.SimpleNamespace(NDTNetSegmentation=RefSegmentation,
                            NDTNetClassification=RefClassification)


@pytest.fixture
def stand_in_reference(monkeypatch):
    """Both sides' load_reference_module give the stand-in module."""
    monkeypatch.setattr(jax_reference_loader, "load_reference_module",
                        lambda name, *a, **k: REF)
    monkeypatch.setattr(parity_train.reference_loader, "load_reference_module",
                        lambda name, *a, **k: REF)


@pytest.mark.parametrize("task", ["segmentation", "classification"])
def test_parity_dataset_equals_jax(task):
    got = parity_train.build_dataset(task, 300, 3, 2, 4, 1)
    want = jax_parity.build_dataset(task, 300, 3, 2, 4, 1)
    assert got[2] == want[2]
    for split_g, split_w in zip(got[:2], want[:2]):
        for a, b in zip(split_g, split_w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def test_parity_preprocess_equals_jax_op_by_op():
    (pts, _, gt), _, n_classes = parity_train.build_dataset(
        "segmentation", 512, 3, 1, 4, 0)
    got = parity_train.preprocess(pts, gt, 32, n_classes, chunk=4,
                                  device="cpu")
    with jax.disable_jit():
        want = jax_parity.preprocess(pts, gt, 32, n_classes, chunk=4)
    for key in ("mask", "gt"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["pcl"], want["pcl"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["covs"], want["covs"], rtol=1e-5,
                               atol=1e-6)


def parity_data(task, n_classes=4, n=512, m=32, train=8, test=4):
    (tr_pts, tr_lab, tr_gt), (te_pts, te_lab, te_gt), n_classes = (
        parity_train.build_dataset(task, n, train, test, n_classes, 0))
    train_d = parity_train.preprocess(tr_pts, tr_gt, m, n_classes, chunk=4,
                                      device="cpu")
    test_d = parity_train.preprocess(te_pts, te_gt, m, n_classes, chunk=4,
                                     device="cpu")
    return train_d, test_d, tr_lab, te_lab, n_classes


@pytest.mark.parametrize("task", ["segmentation", "classification"])
def test_parity_train_torch_equals_jax(stand_in_reference, task):
    """The reference side is the JAX tool's train_torch: the same curves
    from the same stand-in init and order."""
    train_d, test_d, tr_lab, te_lab, n_classes = parity_data(task)
    perms = [np.random.default_rng(13).permutation(8)]
    runs = []
    for side in (parity_train, jax_parity):
        torch.manual_seed(0)
        t_model = REF.NDTNetSegmentation(3, n_classes, 16) if task == \
            "segmentation" else REF.NDTNetClassification(3, n_classes, 16)
        runs.append(side.train_torch(t_model, task, train_d, test_d, tr_lab,
                                     te_lab, perms, 4, 1e-3, "intent",
                                     eval_every=1))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 1 and 0.0 <= runs[0][1] <= 1.0


@pytest.mark.parametrize("task", ["segmentation", "classification"])
def test_parity_port_side_matches_jax_train_ndtpu_f64(stand_in_reference,
                                                      task):
    """One epoch of the port side against JAX's train_ndtpu from the same
    transplanted init, both in float64: the loss curve within 1e-5
    relative, the train accuracy curve equal."""
    train_d, test_d, tr_lab, te_lab, n_classes = parity_data(task)
    perms = [np.random.default_rng(13).permutation(8)]
    t_model, model = parity_train.make_models(task, n_classes, 16, 0, "cpu",
                                              torch.float64)
    _, variables = jax_parity.make_torch_models(task, n_classes, 16, 0)
    with jax.enable_x64(True):
        j_curve, j_test, j_loss, _, _, _ = jax_parity.train_ndtpu(
            variables, task, train_d, test_d, tr_lab, te_lab, perms, 4,
            1e-3, n_classes, 16, f64=True)
    p_curve, p_test, p_loss, _, _, finals = parity_train.train_port(
        model, task, train_d, test_d, tr_lab, te_lab, perms, 4, 1e-3,
        n_classes)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    assert p_curve == pytest.approx(j_curve, abs=1e-12)
    assert p_test == pytest.approx(j_test, abs=1e-12)
    assert all(v.dtype == torch.float64 for k, v in finals.items()
               if "running" in k)


def test_parity_main_writes_both_sides(stand_in_reference, tmp_path, capsys):
    out = tmp_path / "parity.json"
    result = parity_train.main([
        "--device", "cpu", "--task", "segmentation", "--epochs", "1",
        "--train_size", "4", "--test_size", "4", "--n_samples", "512",
        "--n_desired_nds", "32", "--n_classes", "4", "--feature_dim", "16",
        "--batch_size", "4", "--out", str(out), "--perturb_init", "1e-6",
        "--perturb_side", "torch", "--save_finals", str(tmp_path / "f")])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert {"ndtpu_torch", "torch_reference"} <= set(result)
    assert 0.0 <= result["ndtpu_torch"]["test_accuracy"] <= 1.0
    assert (tmp_path / "f_ndtpu_torch.pt").exists()
    assert (tmp_path / "f_torch.pt").exists()
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result


def test_parity_without_reference_raises_naming_it(monkeypatch, tmp_path):
    from ndtpu_torch.interop import reference_loader

    monkeypatch.setattr(reference_loader, "DEFAULT_REF",
                        str(tmp_path / "ref" / "ndnet" / "models"))
    monkeypatch.setattr(reference_loader.load_reference_module, "__defaults__",
                        (reference_loader.DEFAULT_REF, False))
    with pytest.raises(FileNotFoundError, match="ref/ndnet/models"):
        parity_train.make_models("segmentation", 4, 16, 0, "cpu")
