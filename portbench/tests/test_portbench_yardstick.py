"""The benchmark's arithmetic against counts by hand: the models' forward
operations (checked against torch's own count of the reference models'
matmuls at a small shape) and K1's bytes."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs, spec, yardstick
from portbench.reference import models as ref
from portbench.reference.ndt import max_segments

NDTNET = spec.found("families", "ndtnet_seg")
NDTNETPP = spec.found("families", "ndtnetpp_seg")


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_ndtnet_seg_flops_match_torch_count():
    cfg = {"family": "ndtnet_seg", "feature_dim": 48, "n_classes": 5}
    b, m = 2, 40
    w = inputs.weights(NDTNET.param_specs(cfg), 0, "cpu")
    pts, covs = torch.randn(b, m, 3), torch.randn(b, m, 9)
    counted = _counted(lambda: ref.ndtnet_seg_logits(w, pts, covs, True))
    assert NDTNET.forward_flops(cfg, b, m) == counted


def test_ndtnet_seg_macs_by_hand():
    # one ND row of the published widths (feature_dim 768, 28 classes):
    # T-Net(3) 3*64 + 64*128 + 128*1024; transforms 9 + 27; conv1 12*64;
    # T-Net(64) 64*64 + 64*128 + 128*1024; x.t2 64*64; conv2 64*128;
    # conv3 128*768; head 832*512 + 512*256 + 256*128 + 128*29
    row = (192 + 8192 + 131072 + 36 + 768 + 4096 + 8192 + 131072 + 4096
           + 8192 + 98304 + 425984 + 131072 + 32768 + 3712)
    per_cloud = (1024 * 512 + 512 * 256 + 256 * 9) + (1024 * 512 + 512 * 256 + 256 * 4096)
    cfg = {"family": "ndtnet_seg", "feature_dim": 768, "n_classes": 28}
    assert NDTNET.forward_flops(cfg, 16, 2080) == 2 * (16 * 2080 * row + 16 * per_cloud)
    assert abs(row - 0.99e6) < 0.01e6


def test_ndtnetpp_seg_flops_match_torch_count():
    cfg = {"family": "ndtnetpp_seg", "feature_dim": 24, "n_classes": 3,
           "fine_nds": 40, "coarse_nds": 20}
    b = 2
    w = inputs.weights(NDTNETPP.param_specs(cfg), 0, "cpu")
    k = 60
    state = {"counts": torch.ones(b, k, dtype=torch.int32),
             "num_valid": torch.full((b,), k, dtype=torch.int32),
             "min_kl": torch.rand(b, k), "means": torch.randn(b, k, 3),
             "covs": torch.randn(b, k, 3, 3), "class_hist": torch.ones(b, k, 4, dtype=torch.int32)}
    fine = (torch.randn(b, 40, 3), torch.randn(b, 40, 9))
    coarse = (torch.randn(b, 20, 3), torch.randn(b, 20, 9))
    counted = _counted(lambda: ref.ndtnetpp_seg_logits(w, fine, coarse, state, 20, True))
    assert NDTNETPP.forward_flops(cfg, b) == counted


def test_ndtnetpp_residual_gemms_by_hand():
    cfg = {"family": "ndtnetpp_seg", "feature_dim": 1024, "n_classes": 28,
           "fine_nds": 8160, "coarse_nds": 4080}
    residuals = 2 * 2 * (4 * 1024 * 8160 * 4080)
    total = NDTNETPP.forward_flops(cfg, 4)
    assert 0.78 < residuals / total < 0.82        # ~546 of ~685 GFLOP
    assert abs(total - 685e9) < 10e9


def test_k1_bytes_by_hand():
    # 16 clouds x 70000 kept points, 2080 NDs, 29 class slots, 3 tags:
    # 9 staged columns a point (seg, x, y, z, v, 3 tags, cls), rows of
    # 13 + 29 + 3 floats
    k = max_segments(2080)
    assert k == 2504
    assert yardstick.k1_bytes(16 * 70000, 16, k, 29) == 4 * 16 * 70000 * 9 + 4 * 16 * k * 45
    assert yardstick.k1_bytes(128 * 70000, 128, 1208, 0) == 4 * 128 * 70000 * 8 + 4 * 128 * 1208 * 16
    t = yardstick.k1_bound_s(16 * 70000, 16, k, 29)
    assert abs(t - yardstick.k1_bytes(16 * 70000, 16, k, 29) / 3.35e12) < 1e-12
