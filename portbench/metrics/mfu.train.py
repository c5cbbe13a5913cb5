"""The whole train step's share of the card's float32 peak over the
timed window: the model's forward operations from its shapes (its
family's ``forward_flops``), times 3 (forward and backward), times the
steps, over the window's time."""
from portbench.yardstick import PEAK_F32_FLOPS


def read(run):
    w = run.window
    flops = 3 * run.family.forward_flops(run.cfg, run.traffic["batch"]) * w["steps"]
    return 100.0 * flops / w["elapsed"] / PEAK_F32_FLOPS
