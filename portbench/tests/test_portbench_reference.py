"""The plain reference at a small size on the CPU, against the program's
plain path: the same voxel sizes bit for bit, the same point and class
counts, moments to float32 rounding, the same logits from the same NDs."""
from __future__ import annotations

import torch

from portbench import inputs, program, spec
from portbench.reference import models as ref
from portbench.reference import ndt as rndt


def test_preprocessing_matches_the_program_on_cpu():
    from ndtpu_torch.core.ndt import _fixed_rounds

    pts, tags = inputs.clouds(3, 4, 4096, 4, "cpu")
    cfg = {"n_classes": 4, "search": "probe"}
    for t in (None, tags):
        mine = rndt.downsample(pts, 128, t, 4 if t is not None else 0)
        with _fixed_rounds():  # as a graph step runs it
            prog = program.preprocess(cfg, 128, pts, t)["state"]
        assert torch.equal(mine["voxel_size"], prog["voxel_size"])
        assert torch.equal(rndt.searched_size(pts, 128), prog["voxel_size"])
        assert torch.equal(mine["counts"], prog["counts"])
        assert torch.equal(mine["class_hist"], prog["class_hist"])
        assert torch.equal(mine["zyx"], prog["zyx"])
        torch.testing.assert_close(mine["means"], prog["means"], rtol=0, atol=1e-5)
        torch.testing.assert_close(mine["covs"], prog["covs"], rtol=0, atol=1e-5)


def test_fixed_voxel_size_and_emit():
    pts, tags = inputs.clouds(4, 2, 4096, 4, "cpu")
    sizes = torch.tensor([0.9, 1.1])
    mine = rndt.downsample(pts, 128, tags, 4, voxel_size=sizes)
    prog = program.preprocess({"n_classes": 4, "search": "probe"}, 128, pts, tags,
                              voxel_sizes=sizes)
    assert torch.equal(mine["voxel_size"], prog["state"]["voxel_size"])
    # the reference's emit of the program's state is the program's output
    p, c, oh, m = rndt.model_inputs(prog["state"], 128, 4)
    assert torch.equal(m, prog["mask"]) and torch.equal(oh, prog["onehot"])
    assert torch.equal(p, prog["points"]) and torch.equal(c, prog["covs"])


def test_reference_model_matches_the_program_model():
    from ndtpu_torch.models.ndtnet import NDTNetSegmentation

    cfg = {"family": "ndtnet_seg", "feature_dim": 32, "n_classes": 4}
    w = inputs.weights(spec.found("families", "ndtnet_seg").param_specs(cfg), 1, "cpu")
    model = NDTNetSegmentation(num_classes=4, feature_dim=32, device="cpu")
    model.load_state_dict(w)
    pts, covs = torch.randn(2, 50, 3), torch.randn(2, 50, 9)
    for train in (False, True):  # eval first: a train forward moves the running statistics
        model.train(train)
        want = model(pts, covs, return_logits=True)
        got = ref.ndtnet_seg_logits(w, pts, covs, train)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
