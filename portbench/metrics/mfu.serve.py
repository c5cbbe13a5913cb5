"""The whole request's share of the card's float32 peak over the timed
window: the model's forward operations from its shapes (its family's
``forward_flops``), times the
requests, over the window's time."""
from portbench.yardstick import PEAK_F32_FLOPS


def read(run):
    w = run.window
    flops = run.family.forward_flops(run.cfg, run.traffic["clouds_per_request"],
                                     run.cfg["serve_nds"]) * w["steps"]
    return 100.0 * flops / w["elapsed"] / PEAK_F32_FLOPS
