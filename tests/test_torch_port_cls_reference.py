"""The benchmark's NDT-Net classification cell (``ndtnet-cls.train-graph``)
at small sizes on the CPU: the program's ``NDTNetClassification`` against
the plain reference (``portbench/reference/cls.py``) on the benchmark's
seeded weights, the cell's label rule from the program's and the
reference's NDT states, K1's roofline bound of the cell against
serving's, and the cell's set-up and judge, correct as the program
stands and not correct with each training fault planted.
"""
import types

import pytest
import torch

from portbench import calibrate, faults, inputs, spec
from portbench.reference import cls as rcls
from portbench.reference import models as ref
from portbench.reference import ndt as rndt

from ndtpu_torch.models.ndtnet import NDTNetClassification
from ndtpu_torch.train import loop

CELL = "ndtnet-cls.train-graph"
B, M, F, C = 4, 32, 32, 8
SMALL = {"n_points": 4096, "n_classes": C, "feature_dim": F, "train_nds": 128,
         "train_split": 32}


def family():
    return spec.Cell(CELL).family


def small_cell():
    cell = spec.Cell(CELL)
    cell.cfg = {**cell.cfg, **SMALL}
    cell.traffic = {**cell.traffic, "batch": 8, "split": 32}
    return cell


def inputs_with_padding():
    """Points and covariances [B, M, .] whose clouds keep 32, 12, 4 and 2
    rows, the rest zero as the emit pads them: with so few kept rows the
    padded rows' features win the pool in some channels."""
    g = torch.Generator().manual_seed(0)
    pts, covs = torch.randn(B, M, 3, generator=g), torch.randn(B, M, 9, generator=g)
    kept = torch.arange(M)[None] < torch.tensor([32, 12, 4, 2])[:, None]
    return pts * kept[..., None], covs * kept[..., None], kept


def test_program_model_matches_the_reference():
    """Eval logits (first: a train forward moves the running statistics),
    then train-mode logits, the loss and every parameter's gradient.
    Tolerances: the program and the reference run the same float32
    operations in the same order (on the CPU they agree bit for bit); 1e-5
    on the logits and the loss, 1e-4 relative on the gradients, leave room
    for another BLAS's blocking of the same products. A reference that
    pools only the kept rows misses by far more."""
    fam, cfg = family(), {"feature_dim": F, "n_classes": C}
    w = inputs.weights(fam.param_specs(cfg), 5, "cpu")
    model = NDTNetClassification(num_classes=C, feature_dim=F, device="cpu")
    model.load_state_dict(w)
    pts, covs, kept = inputs_with_padding()
    onehot = torch.eye(C)[[1, 3, 5, 7]]

    model.eval()
    with torch.no_grad():
        want = model(pts, covs, return_logits=True)
    torch.testing.assert_close(rcls.ndtnet_cls_logits(w, pts, covs, False), want,
                               rtol=1e-5, atol=1e-5)

    model.train()
    names = [n for n, _ in model.named_parameters()]
    want = model(pts, covs, return_logits=True)
    loss_want = loop.cross_entropy_loss(want, onehot)
    grads_want = torch.autograd.grad(loss_want, list(model.parameters()))
    p = {n: t.clone().requires_grad_(n in names) for n, t in w.items()}
    got = rcls.ndtnet_cls_logits(p, pts, covs, True)
    loss = ref.masked_cross_entropy(got, onehot, torch.ones(B, dtype=torch.bool))
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss, loss_want, rtol=1e-5, atol=1e-5)
    for n, a, b in zip(names, grads, grads_want):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale, msg=n)

    # the same head on the kept rows' pool alone: the check above would fail
    net = ref.Net(w, True)
    x, _ = net.ndtnet("feature_extractor.", pts, covs)
    h = x.masked_fill(~kept[..., None], float("-inf")).amax(dim=1)
    h = torch.relu(net.dense("conv2", torch.relu(net.dense("conv1", h))))
    dropped = net.dense("conv3", h)
    assert float((dropped - want.detach()).abs().max()) > 100 * 1e-5


def test_label_rule_from_the_program_and_the_reference():
    """The labels the cell's driver makes at set-up (the program's eager,
    untagged preprocessing over the split, a batch at a time) are the
    one-hot of each cloud's occupied voxel count modulo the classes from
    the reference's untagged state. The check steps' graph step, whose
    search runs fixed rounds, reaches the same counts bit for bit, so
    ``reference_logits`` hands the loss the labels the program trained on."""
    cell = small_cell()
    fam, (nds,) = cell.family, cell.family.resolutions(cell.cfg)
    drv = cell.driver(cell, 2**31 + 5, torch.device("cpu"))
    drv.setup()
    mine = rndt.downsample(drv.points, nds, tags=None)
    want = fam.labels(mine["num_valid"], C)
    assert torch.equal(drv.tags, want)
    assert torch.equal(want.argmax(-1), mine["num_valid"].long() % C)
    assert torch.equal(want.sum(-1), torch.ones(drv.split))
    w = inputs.weights(fam.param_specs(cell.cfg), 1, "cpu")
    for rows, preps in zip(drv.check_rows, drv.preps):
        _, onehot, mask = fam.reference_logits(cell.cfg, w, preps, [nds], False)
        assert torch.equal(onehot, want[torch.as_tensor(rows)]) and bool(mask.all())
    drv.release()


def test_k1_roofline_cls_bound_is_serving_formula():
    """At no class slots the cell's K1 bound is the one serving reckons
    for the same points, clouds and segments; no K1 launch, no value."""
    cls_read = spec.found("metrics", "k1_roofline.cls").read
    serve_read = spec.found("metrics", "k1_roofline.serve").read
    tr = types.SimpleNamespace(kernel=lambda name: (32, 4.2e-5))
    common = dict(trace=tr, k1_name="segment_moments_kernel", k1_points_per_cloud=65432.5)
    a = cls_read(types.SimpleNamespace(cfg={"train_nds": 1000}, traffic={"batch": 16},
                                       **common))
    b = serve_read(types.SimpleNamespace(cfg={"serve_nds": 1000},
                                         traffic={"clouds_per_request": 16}, **common))
    assert a == b and 0 < a < 100
    common["trace"] = types.SimpleNamespace(kernel=lambda name: (0, None))
    assert cls_read(types.SimpleNamespace(cfg={"train_nds": 1000}, traffic={"batch": 16},
                                          **common)) is None


@pytest.mark.parametrize("fault", (None,) + faults.TRAIN_FAULTS)
def test_cell_reading_is_correct_and_each_fault_is_not(fault):
    """The cell's set-up through its driver (labels, the check steps of
    the epoch scan) and its judge at a small size on the CPU, its limits
    as committed: ``calibrate.reading``, a run without the window, whose
    check of loaded modules this suite's JAX would trip."""
    cell = small_cell()
    r = calibrate.reading(cell, 2**31 + 17, 0.0, torch.device("cpu"), fault)
    assert r["correct"] == (fault is None), r
