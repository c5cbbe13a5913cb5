"""K1's share of its roofline in a train step: its least time (each kept
point's staged columns read once, its rows written once, at the memory
rate; 29 class slots, 3 tag columns), averaged over the step's
resolutions, over its mean device time a launch in the trace."""
from portbench.reference.ndt import max_segments
from portbench.yardstick import k1_bound_s


def read(run):
    launches, mean_s = run.trace.kernel(run.k1_name) if run.trace else (0, None)
    if not launches:
        return None
    b, slots = run.traffic["batch"], run.cfg["n_classes"] + 1
    nds = run.family.resolutions(run.cfg)
    points = run.k1_points_per_cloud * b
    bound = sum(k1_bound_s(points, b, max_segments(n), slots) for n in nds) / len(nds)
    return 100.0 * bound / mean_s
