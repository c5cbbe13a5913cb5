"""The readings that a cell's limits are set from, in one process on the
card (the benchmark's own runs never run this):

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control_seeds a,b,c] [--faults half_batch,...] [--seconds 2] \\
        [--out <file>.json]

For each of ``--seeds``: the cell set up from the seed as a run sets it
up, its first steps (training) or a short window of requests (serving,
``--seconds`` long, at the cell's own load), and every number compared
against the reference: the program's readings, whose largest is a
limit's lower reading. For each of ``--control_seeds``: the control, the
reference put in the program's place and computed one precision below
the configuration's (TF32 matmuls for the model's float32 with TF32 off;
each point's moment columns in bfloat16 for the preprocessing's plain
float32), judged the same way. For each fault of ``--faults`` (``portbench/faults.py``) and
each control seed: the program with that fault planted. Prints one JSON
line a reading and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import faults, judge
from portbench.reference import ndt as rndt
from portbench.spec import Cell


def control_evidence(cell, drv, ev):
    """The control's evidence for the same inputs as the program's
    ``ev``: the reference in the program's place, one precision below
    (a streaming cell's set-up search too: its sizes are the control's)."""
    cfg, family = cell.cfg, cell.family
    if ev["kind"] == "train":
        batches, preps = [], []
        with judge.reference_precision(tf32=True):
            for pts, tags, sizes in ev["batches"]:
                nds = family.resolutions(cfg)
                if sizes is not None:
                    sizes = rndt.searched_size(pts, nds[0])
                batches.append((pts, tags, sizes))
                preps.append([rndt.downsample(pts, n, tags, cfg["n_classes"],
                                              voxel_size=sizes, columns=torch.bfloat16)
                              for n in nds])
        losses, grad1, params3 = judge.follow_train(cell, drv.weights, preps, tf32=True)
        return {**ev, "batches": batches, "preps": preps, "losses": losses,
                "grad1": grad1, "params3": params3}
    sample, nds = [], cfg["serve_nds"]
    with judge.reference_precision(tf32=True):
        for s in ev["sample"]:
            pts = ev["pool"][s["slot"]].to(drv.device)
            st = rndt.downsample(pts, nds, columns=torch.bfloat16)
            with torch.no_grad():
                logits, _, m = family.reference_logits(cfg, drv.weights, [st], [nds], False)
            sample.append({"slot": s["slot"], "logits": logits, "mask": m, "state": st})
    return {**ev, "sample": sample}


def reading(cell, seed, seconds, device, fault=None, control=False):
    """One set-up, its first steps or a short window, and the numbers."""
    t0 = time.perf_counter()
    kind = cell.driver.kind
    with faults.plant(fault, kind) if fault else contextlib.nullcontext():
        drv = cell.driver(cell, seed, device)
        drv.setup()
        if kind == "serve":
            drv.window(seconds)
        ev = drv.evidence()
    drv.release()
    torch.cuda.empty_cache()
    if control:
        ev = control_evidence(cell, drv, ev)
    values = judge.numbers(cell, drv.weights, ev, device)
    ok, _ = judge.verdict(values, cell.limits)
    who = "control" if control else (fault or "program")
    return {"cell": cell.name, "who": who, "seed": seed, "correct": ok,
            "seconds": time.perf_counter() - t0, **values}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    jobs = ([(s, None, False) for s in seeds] + [(s, None, True) for s in control]
            + [(s, f, False) for f in args.faults.split(",") if f for s in control])
    out = []
    for seed, fault, ctl in jobs:
        r = reading(cell, seed, args.seconds, device, fault, ctl)
        out.append(r)
        print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
