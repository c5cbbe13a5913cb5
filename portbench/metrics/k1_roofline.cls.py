"""K1's share of its roofline in a classification train step: its least
time (each kept point's staged columns read once, its rows written
once, at the memory rate; untagged: no class slots, 3 tag columns, as
``k1_roofline.serve`` reckons a launch) over its mean device time a
launch in the trace."""
from portbench.reference.ndt import max_segments
from portbench.yardstick import k1_bound_s


def read(run):
    launches, mean_s = run.trace.kernel(run.k1_name) if run.trace else (0, None)
    if not launches:
        return None
    b = run.traffic["batch"]
    bound = k1_bound_s(run.k1_points_per_cloud * b, b,
                       max_segments(run.cfg["train_nds"]), 0)
    return 100.0 * bound / mean_s
