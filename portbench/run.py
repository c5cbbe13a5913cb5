"""Run one cell of the port's benchmark once, on the card of this machine:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up from the seed (data and weights made on the card, the program's
objects, every shape the cell uses warmed up), measures for ``--seconds``,
then judges the outputs against the plain reference. ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` runs the same window,
then a short block under the profiler, and reports the per-layer
metrics. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from portbench.spec import ROOT, Cell, forbidden_modules  # noqa: E402


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ["USE_FLAX"] = "0"


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def per_layer(cell, drv, win, tr, ev):
    """The traced run's extra readings, and each per-layer metric."""
    import numpy as np

    from portbench import program

    states = ([st for prep in ev["preps"] for st in prep]
              if ev["kind"] == "train" else [s["state"] for s in ev["sample"]])
    per_cloud = float(np.mean([float(s["counts"].sum()) / s["counts"].shape[0]
                               for s in states]))
    run = types.SimpleNamespace(
        cfg=cell.cfg, traffic=cell.traffic, family=cell.family, window=win, trace=tr,
        k1_points_per_cloud=per_cloud,
        syncs=getattr(drv, "probe_syncs", None), stage_ms=getattr(drv, "probe_stage_ms", None),
        k1_name=program.k1_name())
    out = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def finite(v):
    """A number JSON can hold: an infinite gap as 1e300, NaN as None."""
    if v != v:
        return None
    return max(min(v, 1e300), -1e300)


def run_cell(cell, seed, seconds, trace_on, device):
    """Set up, measure, trace if asked, judge: (result, [(number, value,
    limit)]). Fails (exit 2, no result) if a forbidden module is loaded
    by the end of the window."""
    import torch

    from portbench import judge, trace

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_import = time.perf_counter()
    drv = cell.driver(cell, seed, device)
    t_made = time.perf_counter()
    drv.setup()
    t_setup = time.perf_counter()
    setup_s = t_setup - T0
    phases = " ".join(f"{k} {v:.3f}" for k, v in getattr(drv, "phases", {}).items())
    print(f"setup_s {setup_s:.3f}: to the cell {t_import - T0:.3f}, driver {t_made - t_import:.3f} "
          f"({phases}), warm-up {t_setup - t_made:.3f}", file=sys.stderr, flush=True)
    win = drv.window(seconds)
    tr = None
    if trace_on:
        tr = trace.traced(drv.traced_block)
        if hasattr(drv, "syncs"):
            drv.probe_syncs = drv.syncs()
        if hasattr(drv, "stage_ms"):
            drv.probe_stage_ms = drv.stage_ms()
    memory_peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        memory_peak = torch.cuda.max_memory_allocated(device)
    bad = forbidden_modules()
    if bad:
        fail(f"loaded by the end of the window: {', '.join(bad)}")

    ev = drv.evidence()
    metrics = per_layer(cell, drv, win, tr, ev) if trace_on else None
    weights = drv.weights
    drv.release()
    del drv
    if cuda:
        torch.cuda.empty_cache()
    values = judge.numbers(cell, weights, ev, device)
    correct, rows = judge.verdict(values, cell.limits)

    if not trace_on:
        e2e = {"setup_s": setup_s, **win["e2e"]}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": info}
    if tr is not None:
        info["busy_s"], info["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": finite(v), "limit": lim} for n, v, lim in rows}
    return result, rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    cell = Cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
    bad = forbidden_modules()
    if bad:
        fail(f"loaded at start: {', '.join(bad)}")
    device = torch.device("cuda", 0)
    result, rows = run_cell(cell, args.seed, args.seconds, args.trace, device)
    bad = forbidden_modules()
    if bad:
        fail(f"loaded by the end of the run: {', '.join(bad)}")
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
